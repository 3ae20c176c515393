"""The reference CNN as a ``torch.nn.Module``.

``Conv(1->32, 3x3) -> relu -> Conv(32->64, 3x3) -> relu -> maxpool(2) ->
dropout(.25) -> flatten -> Linear(9216->128) -> relu -> dropout(.5) ->
Linear(128->10) -> log_softmax``: 28x28 input -> 26 -> 24 -> pool -> 12,
so the flatten width is 64*12*12 = 9216 (~1.2M params).

Weights live in torch's native layout (OIHW convs, ``[out, in]`` Linear,
fc1 columns in NCHW flatten order), so a ``.pt`` written by the JAX
package's ``--save-model`` loads with ``load_state_dict`` as it is.  The
public input contract stays the JAX one — ``[n, 28, 28, 1]`` float32,
channels last — and the forward moves the (size-1) channel axis itself.

The forward takes the JAX ``Net``'s two run options (``--conv-impl``,
``--bf16``) as arguments; the parameters are the same under all of them:

- ``conv_impl``: ``"conv"`` (cuDNN's convolution), ``"im2col_c1"`` (conv1
  as patch extraction plus one matmul) or ``"im2col"`` (both convs so);
  the same products summed in another order.  The patch features are
  ordered (C, kh, kw), the order of an OIHW weight's flatten (JAX's
  ``Im2colConv`` orders (kh, kw, C) for its HWIO kernel).
- ``compute_dtype``: with ``torch.bfloat16`` the input is cast to bf16,
  each float32 weight and bias is cast at use, convs, dropout and linears
  run in bf16 with the bias added after the product (flax adds it apart),
  and ``log_softmax`` runs in float32; parameters stay float32.

``Net(use_bn=True)`` is ``mnist_ddp.py --syncbn``'s model: conv -> BN ->
relu for both convs, with :class:`SyncBatchNorm`, the JAX package's
masked, count-weighted cross-replica BatchNorm.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# Per-sample I/O contract, shared by request validation and staging.
INPUT_SHAPE = (28, 28, 1)
NUM_CLASSES = 10

DROPOUT1_RATE = 0.25
DROPOUT2_RATE = 0.5

# Net's conv_impl values (the JAX package's CONV_IMPLS).
CONV_IMPLS = ("conv", "im2col_c1", "im2col")


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """``[n, 28, 28, 1]`` -> ``[n, 1, 28, 28]``.  With one channel the two
    layouts share their memory order, so this is a free view."""
    if x.dim() != 4 or tuple(x.shape[1:]) != INPUT_SHAPE:
        raise ValueError(
            f"expected [n, {', '.join(map(str, INPUT_SHAPE))}] input, got "
            f"shape {tuple(x.shape)}"
        )
    return x.permute(0, 3, 1, 2)


def torch_reset_uniform_(
    module: nn.Module, generator: torch.Generator | None = None
) -> None:
    """torch's Conv2d/Linear ``reset_parameters`` distribution, drawn from
    an explicit generator: kaiming_uniform(a=sqrt(5)) reduces to
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and bias alike."""
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Linear)):
            fan_in = layer.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                for p in (layer.weight, layer.bias):
                    p.uniform_(-bound, bound, generator=generator)


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator
) -> torch.Tensor:
    """Inverted dropout, flax's ``nn.Dropout``: keep each element with
    probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.
    The mask comes from ``torch.rand`` on ``generator`` (which lives on
    ``x``'s device)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    # Divide by a tensor on x's device: CUDA's tensor / python_scalar
    # multiplies by the reciprocal, and 1 / 0.75 is not exact.
    kept = x / torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv(layer: nn.Conv2d, x: torch.Tensor, im2col: bool) -> torch.Tensor:
    """``layer`` (VALID, stride 1) on ``x`` in ``x``'s dtype: the module's
    own call for float32 cuDNN, else the product and then the bias."""
    if not im2col and x.dtype == layer.weight.dtype:
        return layer(x)
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    if im2col:
        n, _, h, wd = x.shape
        out, _, kh, kw = w.shape
        cols = F.unfold(x, (kh, kw))  # [n, C*kh*kw, L], features (C, kh, kw)
        y = torch.matmul(w.reshape(out, -1), cols).view(n, out, h - kh + 1, wd - kw + 1)
    else:
        y = F.conv2d(x, w)
    return y + b.view(-1, 1, 1)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on ``x`` in ``x``'s dtype, the bias added after the
    product when the weight is cast."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


# torch.nn.BatchNorm2d's defaults, which SyncBatchNorm inherits; the
# momentum weights the new batch statistic.
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` over the default group, differentiable: the
    backward all-reduces the incoming gradient, as torch's
    ``SyncBatchNorm`` does with its statistics' gradients, so each rank's
    input gets the gradient of every rank's loss through the shared
    statistics."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class SyncBatchNorm(nn.Module):
    """Cross-rank BatchNorm over NCHW input, ``torch.nn.SyncBatchNorm``'s
    semantics in the JAX package's form (its ``models/net.py``
    ``SyncBatchNorm``).

    In train mode each rank sums the count ``n``, ``s1 = sum x`` and
    ``s2 = sum x^2`` per channel over its real samples only (``mask``, the
    loader's 0/1 weights: the padding rows of a final partial batch stay
    out); with ``sync`` one all-reduce of the three over the default
    process group makes them global, without it they are the rank's own.
    It normalizes with the biased variance, and the running averages blend
    the unbiased one (``n / (n - 1)``, clamped at n = 1 where torch would
    divide by zero) with momentum 0.1.  Statistics are computed in at
    least float32 and the running averages kept in float32; eval mode
    normalizes with them.  The output has the input's dtype."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                sync: bool = False) -> torch.Tensor:
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(stat_dtype)
        if self.training:
            c = x.shape[1]
            if mask is None:
                n = torch.full((1,), x.numel() // c, dtype=stat_dtype, device=x.device)
                s1, s2 = x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))
            else:
                m = mask.to(stat_dtype)
                spatial = torch.full((), x.shape[2] * x.shape[3], dtype=stat_dtype,
                                     device=x.device)
                n = (m.sum() * spatial).reshape(1)
                m = m.view(-1, 1, 1, 1)
                s1, s2 = (x32 * m).sum((0, 2, 3)), (x32 * x32 * m).sum((0, 2, 3))
            if sync:
                n, s1, s2 = _AllReduceSum.apply(torch.cat([n, s1, s2])).split([1, c, c])
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                self.running_mean.copy_((1.0 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1.0 - self.momentum) * self.running_var
                                       + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Net(nn.Module):
    """2-conv MNIST CNN.  Input ``[n, 28, 28, 1]`` float32; output
    ``[n, 10]`` float32 log-probabilities.

    ``generator`` seeds the initial weights; construction never draws from
    torch's global generator.  Dropout runs only in train mode and only
    when ``forward`` is given a dropout generator; otherwise it is the
    identity (eval, and the dropout-off parity runs).  ``use_bn`` adds
    ``bn1``/``bn2`` (:class:`SyncBatchNorm`) after the convs; their
    train-mode statistics leave out the rows whose ``mask`` is 0 and, with
    ``sync_bn``, are summed over the default process group.
    """

    def __init__(self, generator: torch.Generator | None = None, use_bn: bool = False):
        super().__init__()
        # skip_init: build without the default reset, which would draw
        # from the global generator before ours overwrites the values.
        self.conv1 = nn.utils.skip_init(nn.Conv2d, 1, 32, 3)
        self.bn1 = SyncBatchNorm(32) if use_bn else None
        self.conv2 = nn.utils.skip_init(nn.Conv2d, 32, 64, 3)
        self.bn2 = SyncBatchNorm(64) if use_bn else None
        self.fc1 = nn.utils.skip_init(nn.Linear, 9216, 128)
        self.fc2 = nn.utils.skip_init(nn.Linear, 128, NUM_CLASSES)
        torch_reset_uniform_(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        dropout_generator: torch.Generator | None = None,
        conv_impl: str = "conv",
        compute_dtype: torch.dtype = torch.float32,
        mask: torch.Tensor | None = None,
        sync_bn: bool = False,
    ) -> torch.Tensor:
        drop = self.training and dropout_generator is not None
        x = self.features(x, dropout_generator if drop else None, conv_impl, compute_dtype,
                          mask, sync_bn)
        return self.head(x, dropout_generator if drop else None)

    def features(
        self,
        x: torch.Tensor,
        dropout_generator: torch.Generator | None = None,
        conv_impl: str = "conv",
        compute_dtype: torch.dtype = torch.float32,
        mask: torch.Tensor | None = None,
        sync_bn: bool = False,
    ) -> torch.Tensor:
        """The convolutional stage (the JAX package's ``raw_conv_stack``
        and the pipeline's stage 0): ``[n, 28, 28, 1]`` -> convs -> pool
        (-> dropout(.25) given a generator) -> ``[n, 9216]`` in
        ``compute_dtype``, C*H*W order."""
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")
        x = to_nchw(x).to(compute_dtype)
        x = _conv(self.conv1, x, conv_impl in ("im2col_c1", "im2col"))
        if self.bn1 is not None:
            x = self.bn1(x, mask, sync_bn)
        x = _conv(self.conv2, F.relu(x), conv_impl == "im2col")
        if self.bn2 is not None:
            x = self.bn2(x, mask, sync_bn)
        x = F.relu(x)
        x = F.max_pool2d(x, 2)
        if dropout_generator is not None:
            x = dropout(x, DROPOUT1_RATE, dropout_generator)
        return torch.flatten(x, 1)

    def head(self, x: torch.Tensor,
             dropout_generator: torch.Generator | None = None) -> torch.Tensor:
        """The dense head (the pipeline's stage 1 before its loss): fc1 ->
        relu (-> dropout(.5) given a generator) -> fc2 -> float32
        log_softmax."""
        x = F.relu(_linear(self.fc1, x))
        if dropout_generator is not None:
            x = dropout(x, DROPOUT2_RATE, dropout_generator)
        x = _linear(self.fc2, x)
        return F.log_softmax(x.float(), dim=-1)
