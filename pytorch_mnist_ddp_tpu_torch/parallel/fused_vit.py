"""The fused path for the ViT family (``vit_mnist.py --fused``), the JAX
package's ``parallel/fused_vit.py``.

JAX builds its whole run from ``fused.py``'s shared epoch and eval scan
skeletons and a ViT step body.
The port does the same with ``parallel/fused.py``, part for part:

- the dataset on the device: :func:`~.fused.device_put_dataset`, re-exported
  here as in JAX's ``__all__``;
- the epoch's permutation and its wrap-filled, weight-0 final batch:
  ``DataLoader.index_table``, the port's own sampler
  (``parallel/sampler.py``), so a world-of-one run trains on exactly the
  per-batch run's batches and ends on its bits; ``FusedEpoch``'s
  ``perm=`` takes JAX's permutation in its layout
  (``jax.random.permutation(jax.random.fold_in(key, epoch), n)``, each
  global batch cut into the shards' contiguous parts), which is how the
  tests hold this path to JAX's;
- the gather by index and the on-device normalize, or ``pregather``'s one
  gather an epoch: ``FusedEpoch``'s, shared with the CNN;
- the step body (JAX's ``step_fn``: the ViT forward, the masked-mean NLL,
  ``pmean`` of the gradients and the plain per-leaf Adadelta, or ZeRO-1's
  update with ``zero=True``): ``parallel/ddp.py``
  ``make_forward_step_body``, the per-batch ViT's own, with ZeRO-1 chosen
  by the layout of ``state.opt`` as the per-batch ViT chooses it.  No
  dropout, no flat state, no kernel (JAX refuses ``--flash`` here);
- the ``lax.scan`` over the steps: one CUDA graph of the step, captured
  after ``WARMUP_STEPS`` eager steps and replayed for every later one (on
  the CPU the steps run eagerly);
- the eval scan and its one ``psum``: ``FusedEval`` with the ViT's
  forward, one all-reduce of the per-batch table;
- the scan over epochs and the one host read at the end: ``FusedRun``,
  one host read an epoch (the printed lines come from it).

Every rank lies on the data axis, as JAX's ``make_mesh(num_model=1)``
lays out its devices: ``grid`` has no seq or model member.
"""

from __future__ import annotations

from ..data.loader import DataLoader
from .ddp import TrainState, make_forward_step_body
from .distributed import DistState
from .fused import FusedRun, device_put_dataset
from .mesh import RankGrid

__all__ = ["device_put_dataset", "make_fused_vit_run"]


def _forward(model, x):
    return model(x)


def make_fused_vit_run(
    model,
    state: TrainState,
    train_loader: DataLoader,
    test_loader: DataLoader,
    grid: RankGrid = RankGrid(),
    pregather: bool = False,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> FusedRun:
    """The fused run of the ViT ``model`` (trained in place with
    ``state``) over the loaders' sets: ``FusedRun.epoch(e, lr)`` trains
    and evaluates epoch ``e``.  ``grid`` is this rank's data-only grid
    (``make_rank_grid([], world)``); ``state.opt`` per-leaf or ZeRO-1
    chunks over ``grid.data``."""
    if grid.shape[1:] != (1, 1):
        raise ValueError(f"the fused ViT is data-parallel only; grid {grid.shape} has "
                         "seq or model members")
    data = grid.data
    world = DistState(distributed=data.size > 1, rank=data.rank, world_size=data.size)
    body = make_forward_step_body(_forward, rho, eps, grid)
    return FusedRun(model, state, train_loader, test_loader, eval_forward=_forward,
                    dropout=False, world=world, pregather=pregather, body=body)
