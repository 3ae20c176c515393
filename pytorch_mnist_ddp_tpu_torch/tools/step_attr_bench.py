#!/usr/bin/env python
"""Decompose the CNN training step's time on the card by construction (the
JAX package's ``tools/step_attr_bench.py``):
``python -m pytorch_mnist_ddp_tpu_torch.tools.step_attr_bench [--steps N]
[--batch N] [--reps N] [--device cuda|cpu]``.

``tools/trace_attr.py`` answers "where does the step's time go" from a
profiler trace; this tool answers it by timing a ladder of step variants,
each one CUDA graph captured over ``--steps`` iterations (300 at batch 200,
one epoch) and replayed ``--reps`` times, best of the replays, in µs per
iteration: the port's counterpart of a warm jitted ``lax.scan``.  As the
fused CNN epoch does (``parallel/fused.py``), the sets live on the device
and every step gathers its rows by index and normalizes them there
(``normalize_dev``), with the dropout generator registered with the graph.
Consecutive rungs isolate one ingredient:

    empty_scan     the loop, an int carry only        -> per-iteration floor
    gather_norm    + batch gather & normalize         -> input cost
    gather_epoch   one permuted epoch gather +        -> the pregather
                   contiguous slices                     input path
    fwd            + forward & loss (fixed batch)     -> forward compute
    fwd_bwd        + the gradients                    -> backward compute
    full_nodrop    + the Adadelta update, dropout off -> optimizer cost
    full           the real step (dropout on)         -> dropout/RNG cost
    full_nogather  full minus the gather (fixed batch) -> cross-check
    full_pregather full on the pregathered epoch      -> its end-to-end win
    eval           --eval-steps batches of the eval forward

The step is the per-batch trainer's without ``--pallas-opt``: the masked
NLL (weights one), ``torch.autograd.grad``, the per-leaf Adadelta (rho
0.9, eps 1e-6, lr 1), TF32 off and deterministic cuDNN as the trainer
sets them.  A world of one: the data-parallel mean is the identity.

Prints ONE JSON line with JAX's keys (``backend`` is ``gpu`` on the card;
``compile_s`` per rung is the eager warm-up, the capture and the first
replay: a capture compiles nothing).  ``--budget-s`` skips the rungs left
once it is spent and marks the line ``partial``; a SIGTERM flushes the
rungs measured so far as that line and exits 124.  ``--device cuda`` (the
default) raises without a card; ``--device cpu`` prints JAX's error JSON
and exits 1 unless ``--allow-cpu``, which runs the rungs eagerly.
"""

from __future__ import annotations

import argparse
import copy
import json
import signal
import sys
import time

# The known rung-name set (JAX's, in its order): consumers tell rungs
# from metadata by it without running the ladder.  Keep in sync with
# make_ladder (checked in main).
RUNG_NAMES = (
    "full",
    "fwd_bwd",
    "full_nogather",
    "full_pregather",
    "gather_norm",
    "empty_scan",
    "gather_epoch",
    "full_nodrop",
    "fwd",
    "eval",
)
DATASET_ROWS = 60000
DROPOUT_SEED = 1


def ladder_data(steps: int, batch: int, rows: int = DATASET_ROWS) -> dict:
    """JAX's inputs, from ``RandomState(0)``: uint8 images ``[rows, 28,
    28]``, labels in [0, 10) and the permutation table ``[steps, batch]``
    (tiled modulo the set, so steps * batch may exceed it), as numpy."""
    import numpy as np

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (rows, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, rows).astype(np.int32)
    idx = np.arange(steps * batch) % rows
    perm = rng.permutation(rows)[idx].reshape(steps, batch)
    return {"images": images, "labels": labels, "perm": perm}


def make_ladder(model, data: dict, *, steps: int, batch: int, eval_batch: int,
                eval_steps: int, compute_dtype=None, conv_impl: str = "conv") -> dict:
    """``{rung: run(iters) -> accumulator}`` over ``model`` and ``data``
    (:func:`ladder_data`'s arrays) on the model's device.  ``run`` does
    ``iters`` iterations of its rung (``eval``'s are eval batches) and
    returns the live f32 accumulator the JAX rung returns; each ``full``
    rung trains its own copy of ``model`` and of fresh accumulators from
    ``run`` to ``run``; the others leave ``model`` as it is.  A rung's
    ``generator`` attribute is its dropout generator, else None."""
    import torch

    from ..ops.adadelta import adadelta_init, adadelta_update
    from ..ops.loss import nll_loss
    from ..parallel.fused import normalize_dev

    dtype = compute_dtype or torch.float32
    device = next(model.parameters()).device
    images = torch.from_numpy(data["images"]).to(device)
    labels = torch.from_numpy(data["labels"].astype("int64")).to(device)
    perm = torch.from_numpy(data["perm"].astype("int64")).to(device)
    fixed_x = normalize_dev(images[:batch])
    fixed_y = labels[:batch]
    w = torch.ones(batch, dtype=torch.float32, device=device)
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=device)

    def loss_of(net, x, y, generator=None):
        net.train(generator is not None)
        logp = net(x, generator, conv_impl, dtype)
        return nll_loss(logp, y, w, reduction="mean")

    def params_of(net):
        return dict(net.named_parameters())

    def empty(iters):
        carry = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(iters):
            carry = carry + 1
        return carry

    def gather_norm(iters):
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(iters):
            x = normalize_dev(images.index_select(0, perm[i]))
            y = labels.index_select(0, perm[i])
            carry = carry + x.sum() + y.sum()
        return carry

    def gather_epoch(iters):
        # One permuted gather of the epoch up front, then contiguous
        # slices a step: the same rows in the same order.
        flat = perm.reshape(-1)
        ep_x, ep_y = images.index_select(0, flat), labels.index_select(0, flat)
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(iters):
            x = normalize_dev(ep_x[i * batch:(i + 1) * batch])
            carry = carry + x.sum() + ep_y[i * batch:(i + 1) * batch].sum()
        return carry

    @torch.no_grad()
    def fwd(iters):
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            x = fixed_x + carry * tiny  # carry-dependent input, as JAX's
            carry = carry + loss_of(model, x, fixed_y)
        return carry

    def fwd_bwd(iters):
        params = params_of(model)
        # JAX's first gradient leaf in its tree order: conv1's bias
        first = list(params).index("conv1.bias")
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            x = fixed_x + carry.detach() * tiny  # see fwd
            loss = loss_of(model, x, fixed_y)
            grads = torch.autograd.grad(loss, list(params.values()))
            carry = (carry + loss + grads[first].sum()).detach()
        return carry

    @torch.no_grad()
    def evaluate(iters):
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        correct = torch.zeros((), dtype=torch.float32, device=device)
        ones = torch.ones(eval_batch, dtype=torch.float32, device=device)
        model.eval()
        for i in range(iters):
            start = i * eval_batch
            x = normalize_dev(images[start:start + eval_batch])
            y = labels[start:start + eval_batch]
            logp = model(x, None, conv_impl, dtype)
            loss_sum = loss_sum + nll_loss(logp, y, ones, reduction="sum")
            correct = correct + ((logp.argmax(1) == y).to(torch.float32) * ones).sum()
        return loss_sum + correct

    def make_full(dropout: bool, gather: str):
        """gather: 'step' (the per-step index gather), 'none' (the fixed
        batch) or 'epoch' (the pregathered epoch)."""
        net = copy.deepcopy(model)
        params = params_of(net)
        opt = adadelta_init(params)
        generator = torch.Generator(device=device) if dropout else None

        def run(iters):
            if gather == "epoch":
                flat = perm.reshape(-1)
                ep_x, ep_y = images.index_select(0, flat), labels.index_select(0, flat)
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(iters):
                if gather == "step":
                    x = normalize_dev(images.index_select(0, perm[i]))
                    y = labels.index_select(0, perm[i])
                elif gather == "epoch":
                    x = normalize_dev(ep_x[i * batch:(i + 1) * batch])
                    y = ep_y[i * batch:(i + 1) * batch]
                else:
                    x, y = fixed_x, fixed_y
                loss = loss_of(net, x, y, generator)
                grads = torch.autograd.grad(loss, list(params.values()))
                adadelta_update(params, dict(zip(params, grads)), opt, 1.0, 0.9, 1e-6)
                acc = acc + loss.detach()
            return acc

        run.generator = generator
        return run

    # Decision-value order, not ladder order: the rungs the decisions
    # need most run first, and each is flushed as it completes.
    ladder = {
        "full": make_full(dropout=True, gather="step"),
        "fwd_bwd": fwd_bwd,
        "full_nogather": make_full(dropout=True, gather="none"),
        "full_pregather": make_full(dropout=True, gather="epoch"),
        "gather_norm": gather_norm,
        "empty_scan": empty,
        "gather_epoch": gather_epoch,
        "full_nodrop": make_full(dropout=False, gather="step"),
        "fwd": fwd,
        "eval": evaluate,
    }
    return ladder


def time_rung(run, iters: int, reps: int, device) -> tuple[float, float]:
    """``(best seconds of reps, compile seconds)`` for ``iters``
    iterations of ``run``.  On the card: two iterations eagerly on a side
    stream (handles, workspaces and the allocator set up outside the
    graph), then ``iters`` captured in one CUDA graph, replayed ``reps``
    times; ``compile_s`` is the warm-up, the capture and the first
    replay.  On the CPU, ``reps`` eager runs after one."""
    import torch

    generator = getattr(run, "generator", None)

    def seed():  # every run draws the same masks (never under capture)
        if generator is not None:
            generator.manual_seed(DROPOUT_SEED)

    t_c0 = time.perf_counter()
    if device.type != "cuda":
        seed()
        run(iters)
        compile_s = time.perf_counter() - t_c0
        best = float("inf")
        for _ in range(reps):
            seed()
            t0 = time.perf_counter()
            run(iters)
            best = min(best, time.perf_counter() - t0)
        return best, compile_s
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    seed()
    with torch.cuda.stream(side):
        run(min(2, iters))
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    seed()
    with torch.cuda.graph(graph):
        run(iters)

    def replay():
        seed()
        graph.replay()
        torch.cuda.synchronize(device)

    replay()
    compile_s = time.perf_counter() - t_c0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        replay()
        best = min(best, time.perf_counter() - t0)
    del graph
    return best, compile_s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.tools.step_attr_bench")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--eval-batch", type=int, default=1000)
    p.add_argument("--eval-steps", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--bf16", action="store_true",
                   help="run the ladder at the --bf16 compute dtype")
    p.add_argument("--conv-impl", type=str, default="conv",
                   choices=["conv", "im2col_c1", "im2col"],
                   help="run the ladder with a GEMM-lowered conv variant "
                        "(models/net.py)")
    p.add_argument("--allow-cpu", action="store_true")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated rung names to run (e.g. "
                        "'full,fwd_bwd'); unknown names are an error")
    p.add_argument("--budget-s", type=float, default=540.0,
                   help="soft time budget: once exceeded, remaining rungs "
                        "are skipped and the partial JSON still prints")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (the default; raises without one), or the "
                        "CPU (needs --allow-cpu; the rungs run eagerly)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models.net import Net

    device = resolve_device(args.device)
    if device.type == "cpu" and not args.allow_cpu:
        print(json.dumps({
            "metric": "step_attr_us", "error": "cpu backend (no TPU)",
        }))
        return 1
    if device.type == "cuda":
        # the trainer's settings (trainer.py): TF32 off, deterministic cuDNN
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Net(torch.Generator().manual_seed(0)).to(device)
    data = ladder_data(args.steps, args.batch)
    variants = make_ladder(model, data, steps=args.steps, batch=args.batch,
                           eval_batch=args.eval_batch, eval_steps=args.eval_steps,
                           compute_dtype=compute_dtype, conv_impl=args.conv_impl)
    assert set(variants) == set(RUNG_NAMES), (sorted(variants), sorted(RUNG_NAMES))

    if args.only:
        wanted = [w.strip() for w in args.only.split(",") if w.strip()]
        unknown = [w for w in wanted if w not in variants]
        if unknown:
            print(json.dumps({"metric": "step_attr_us",
                              "error": f"unknown rungs: {unknown}"}))
            return 2
        variants = {k: variants[k] for k in wanted}

    result = {
        "metric": "step_attr_us",
        "backend": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "steps": args.steps,
        "batch": args.batch,
        "compute_dtype": "bfloat16" if args.bf16 else "float32",
        "conv_impl": args.conv_impl,
    }

    # A SIGTERM at an outer timeout flushes whatever completed.
    def _flush_partial(signum, frame):
        result.setdefault("partial", True)
        print(json.dumps(result), flush=True)
        sys.exit(124)

    signal.signal(signal.SIGTERM, _flush_partial)
    t_start = time.perf_counter()
    for name, fn in variants.items():
        if time.perf_counter() - t_start > args.budget_s:
            result.setdefault("skipped", []).append(name)
            continue
        # us per iteration ("eval" iterates eval-steps batches; the rest
        # `steps` train steps)
        iters = args.eval_steps if name == "eval" else args.steps
        try:
            best, compile_s = time_rung(fn, iters, args.reps, device)
            result[name] = round(best / iters * 1e6, 2)
            result.setdefault("compile_s", {})[name] = round(compile_s, 1)
        except Exception as e:  # keep the partials
            result[name] = None
            result.setdefault("errors", {})[name] = repr(e)[:200]
        print(f"[rung] {name}: {result.get(name)} us/iter "
              f"(compile {result.get('compile_s', {}).get(name)}s, "
              f"elapsed {time.perf_counter() - t_start:.0f}s)",
              file=sys.stderr, flush=True)
    if "skipped" in result:
        result["partial"] = True
    # Close the handler race before the final print: a SIGTERM landing
    # mid-print must not let the handler append a second JSON object.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
