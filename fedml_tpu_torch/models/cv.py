"""CIFAR ResNet and logistic regression in PyTorch.

Port of ``fedml_tpu/models/cv.py``: ``LogisticRegression``, and
``CIFARResNet`` and ``BasicBlock`` with the BatchNorm branch of ``_norm``
and the ``conv_impl="lax"`` convolution.
Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``), so ``params/BasicBlock_3/Conv_0/kernel`` in
the JAX tree is ``BasicBlock_3.Conv_0.weight`` here
(``utils/weights.py`` converts).

What the reference does, and this module repeats explicitly:

* NHWC at the public ``forward``; the layers run NCHW inside.
* ``dtype`` is the compute dtype: parameters stay float32 and are cast to
  ``dtype`` per op (flax ``dtype=bf16, param_dtype=f32``); the Dense output
  comes back as float32.
* ``padding="SAME"``: a 3x3 stride-2 convolution pads (0, 1) on each
  spatial axis, not (1, 1); the 1x1 shortcut pads nothing.
* BatchNorm (flax ``momentum=0.9``, ``epsilon=1e-5``): train mode
  normalises with the batch mean and the *biased* batch variance over the
  whole batch, padded rows included, and folds
  ``0.9·running + 0.1·batch`` into the running statistics, in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_BN_MOMENTUM = 0.9   # flax convention: weight of the old running value
_BN_EPS = 1e-5


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal in [-2, 2] scaled to
    variance 1/fan_in (``nn.initializers.lecun_normal``)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


class Conv(nn.Module):
    """Bias-free 'SAME' convolution; ``weight`` is OIHW float32."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel_size, kernel_size))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        # SAME: total pad = max((ceil(n/s) - 1)·s + k - n, 0), low = total//2
        pads = []
        for n in (x.shape[-1], x.shape[-2]):          # F.pad order: W, H
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        x = x.to(self.dtype)
        if pads[0] == pads[1] and pads[2] == pads[3]:
            padding = (pads[2], pads[0])
        else:
            x = F.pad(x, pads)
            padding = 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=s,
                        padding=padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` semantics on NCHW input (see module doc)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, _BN_EPS)
        with torch.no_grad():
            # the running update flax computes: f32 stats, fast variance
            # E[x²] − E[x]² clipped at 0 (biased), momentum on the old value
            xf = x.detach().float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            self.running_mean.copy_(_BN_MOMENTUM * self.running_mean
                                    + (1.0 - _BN_MOMENTUM) * mean)
            self.running_var.copy_(_BN_MOMENTUM * self.running_var
                                   + (1.0 - _BN_MOMENTUM) * var)
        # normalisation with the batch mean and biased variance; no running
        # buffers are passed, so torch's own (unbiased) fold never runs
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, _BN_EPS)


class Dense(nn.Module):
    """``nn.Dense``: ``weight`` is [out, in] float32 (the flax kernel
    transposed); computes in ``dtype`` and returns float32 — or ``dtype``
    with ``float_out=False``, as a flax ``Dense`` inside a block does."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, float_out: bool = True):
        super().__init__()
        self.dtype = dtype
        self.float_out = float_out
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                     self.bias.to(self.dtype))
        return y.float() if self.float_out else y


class LogisticRegression(nn.Module):
    """One ``Dense`` over the flattened input (``Dense_0``, as flax names
    it), computed in ``dtype`` with float32 logits; ``sigmoid_output``
    applies the reference's sigmoid to them (``lr_sigmoid_outputs``)."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32,
                 sigmoid_output: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sigmoid_output = sigmoid_output
        self.Dense_0 = Dense(in_features, num_classes, dtype)
        self.Dense_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` and ``rng`` are unused: no dropout, no statistics."""
        z = self.Dense_0(x.reshape(x.shape[0], -1))
        return torch.sigmoid(z) if self.sigmoid_output else z


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.has_shortcut = stride != 1 or in_features != filters
        if self.has_shortcut:
            self.Conv_2 = Conv(in_features, filters, 1, stride, dtype)
            self.BatchNorm_2 = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x
        if self.has_shortcut:
            residual = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(residual + y)


class CIFARResNet(nn.Module):
    """ResNet-20/56 for 32×32 inputs: 3 stages of n blocks, 16/32/64
    filters, n = (depth-2)/6.  Input ``x`` is NHWC."""

    def __init__(self, depth: int = 56, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        n = (depth - 2) // 6
        self.Conv_0 = Conv(in_channels, 16, 3, 1, dtype)
        self.BatchNorm_0 = BatchNorm(16, dtype)
        self.blocks = []
        features = 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                stride = 2 if (stage > 0 and block == 0) else 1
                b = BasicBlock(features, filters, stride, dtype)
                self.add_module(f"BasicBlock_{len(self.blocks)}", b)
                self.blocks.append(b)
                features = filters
        self.Dense_0 = Dense(features, num_classes, dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Fresh variables from ``generator`` (on the module's device):
        flax's initializers (lecun normal kernels, zero biases, unit BN
        scale and variance), drawn by torch, so not JAX's numbers."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``rng`` is unused: the ResNet has no dropout."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for b in self.blocks:
            x = b(x, train)
        # jnp.mean over H, W accumulates a bf16 input in float32
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.Dense_0(x)
