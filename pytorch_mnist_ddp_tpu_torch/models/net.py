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


class Net(nn.Module):
    """2-conv MNIST CNN.  Input ``[n, 28, 28, 1]`` float32; output
    ``[n, 10]`` float32 log-probabilities.  Dropout is inert in eval mode.

    ``generator`` seeds the initial weights; construction never draws from
    torch's global generator.
    """

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        # skip_init: build without the default reset, which would draw
        # from the global generator before ours overwrites the values.
        self.conv1 = nn.utils.skip_init(nn.Conv2d, 1, 32, 3)
        self.conv2 = nn.utils.skip_init(nn.Conv2d, 32, 64, 3)
        self.fc1 = nn.utils.skip_init(nn.Linear, 9216, 128)
        self.fc2 = nn.utils.skip_init(nn.Linear, 128, NUM_CLASSES)
        self.dropout1 = nn.Dropout(DROPOUT1_RATE)
        self.dropout2 = nn.Dropout(DROPOUT2_RATE)
        torch_reset_uniform_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(to_nchw(x)))
        x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, 2)
        x = self.dropout1(x)
        x = torch.flatten(x, 1)  # [n, 9216], C*H*W order
        x = F.relu(self.fc1(x))
        x = self.dropout2(x)
        x = self.fc2(x)
        return F.log_softmax(x.float(), dim=-1)
