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
"""

from __future__ import annotations

import math

import torch
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


class Net(nn.Module):
    """2-conv MNIST CNN.  Input ``[n, 28, 28, 1]`` float32; output
    ``[n, 10]`` float32 log-probabilities.

    ``generator`` seeds the initial weights; construction never draws from
    torch's global generator.  Dropout runs only in train mode and only
    when ``forward`` is given a dropout generator; otherwise it is the
    identity (eval, and the dropout-off parity runs).
    """

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        # skip_init: build without the default reset, which would draw
        # from the global generator before ours overwrites the values.
        self.conv1 = nn.utils.skip_init(nn.Conv2d, 1, 32, 3)
        self.conv2 = nn.utils.skip_init(nn.Conv2d, 32, 64, 3)
        self.fc1 = nn.utils.skip_init(nn.Linear, 9216, 128)
        self.fc2 = nn.utils.skip_init(nn.Linear, 128, NUM_CLASSES)
        torch_reset_uniform_(self, generator)

    def forward(
        self,
        x: torch.Tensor,
        dropout_generator: torch.Generator | None = None,
        conv_impl: str = "conv",
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")
        drop = self.training and dropout_generator is not None
        x = to_nchw(x).to(compute_dtype)
        x = F.relu(_conv(self.conv1, x, conv_impl in ("im2col_c1", "im2col")))
        x = F.relu(_conv(self.conv2, x, conv_impl == "im2col"))
        x = F.max_pool2d(x, 2)
        if drop:
            x = dropout(x, DROPOUT1_RATE, dropout_generator)
        x = torch.flatten(x, 1)  # [n, 9216], C*H*W order
        x = F.relu(_linear(self.fc1, x))
        if drop:
            x = dropout(x, DROPOUT2_RATE, dropout_generator)
        x = _linear(self.fc2, x)
        return F.log_softmax(x.float(), dim=-1)
