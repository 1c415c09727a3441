"""Multi-head U-Net keypoint detector (PyTorch, NCHW inside).

Counterpart of abcnet_tpu/models/unet.py, block for block: stem
DoubleConv pair at 16 channels, encoder 16-32-64(-inc3)-128-256-512 via
max-pool downs, decoder with k3 s2 transposed convs + skip concat, two
trailing DoubleConvs at 128 channels, one OutConv head per output group,
all heads at stride 4. 10,698,575 parameters for the production heads
(1,14,3,2,1,360,60,60), the learned uncertainty weights `s` included.

Layout: the public `forward` takes NHWC images (B, H, W, 1) and returns
NHWC heads (B, H/4, W/4, width) and features, as the JAX module does;
both are views of the NCHW tensors the blocks compute on (a 1-channel
NHWC tensor is already NCHW in memory).

Precision follows the JAX module's `dtype`: parameters stay f32 master
weights, each conv casts its input and weights to `dtype` (bf16 in
production), BatchNorm runs in f32 and its output is cast back after
the activation (`conv_bn_act` -> `BatchNorm.act` -> ops/bn_act.py: in
train mode one op that keeps only the conv output in `dtype` for the
backward; in eval mode one pass; on a GPU both also add the conv bias,
and in train mode return its gradient). Heads stay in `dtype`. No
autocast.

Train mode (`model.train()`) follows Flax, not torch's defaults, in two
places. BatchNorm normalizes with the batch statistics and moves its
running variance with the *biased* batch variance (torch's own update
uses the unbiased one). Dropout in the heads draws its keep mask from
the `generator` handed to `forward`, after the cast to the compute
dtype, so a training run is reproducible from its generator and never
touches the global CUDA stream.

Data parallel: `BatchNorm.group` (set on every BatchNorm of a model by
`parallel.sync_batchnorm`) is the process group of a data-parallel run.
In train mode with more than one rank the batch statistics are those of
the *global* batch (what the JAX package's SPMD step computes over its
mesh), and the backward all-reduces the two sums it needs (ops/bn_act.py);
every rank ends with the same running statistics.

Options of the JAX module (abcnet_tpu/models/unet.py:138-151):
`fused_head_bank=True` computes the eight OutConv 3x3 convs as one conv
of 128·n channels and one BatchNorm over them, then the per-head 1x1s
on the slices (models/fuse_heads.py converts weights both ways);
`remat_blocks` names blocks ("inc1" .. "dconv2", "heads") whose
activations are recomputed in the backward instead of kept
(torch.utils.checkpoint, non-reentrant). A recomputation neither moves
the BatchNorm running statistics a second time nor draws a new dropout
mask.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.bn_act import bn_act, bn_act_eval

PRODUCTION_HEADS: Tuple[int, ...] = (1, 14, 3, 2, 1, 360, 60, 60)

HEAD_NAMES = ("atom_target", "atom_type", "atom_charge", "atom_hs",
              "bond_target", "bond_type", "bond_rho", "bond_omega")

BN_EPS = 1e-5
BN_MOMENTUM = 0.1        # flax momentum 0.9 (the weight of the old value)


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    """Marks the forward that torch.utils.checkpoint runs again in the
    backward (on the autograd thread, so the mark is thread-local)."""
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = False


class BatchNorm(nn.BatchNorm2d):
    """f32 batch norm with Flax's running-statistics update, applied with
    its activation and cast (`act`).

    Eval: normalizes with the running statistics, as nn.BatchNorm2d
    (ops/bn_act.py:bn_act_eval, which adds the conv bias first where it
    is given). Train: normalizes with the batch statistics
    (ops/bn_act.py:bn_act, which keeps only the conv output for the
    backward) and updates

        running = 0.9 * running + 0.1 * batch

    with the biased batch variance, as flax.linen.BatchNorm(momentum=0.9)
    does (abcnet_tpu/models/unet.py:45-46); torch's own update would use
    the unbiased variance, n/(n-1) larger. With a process group of more
    than one rank (`group`), the batch is the global one."""

    group = None

    def act(self, x: torch.Tensor, act: str, dtype: torch.dtype,
            conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """act(bn(x + conv_bias)) in `dtype`, x the conv output; act is
        "relu", "leaky_relu" (slope 0.01) or "none". conv_bias: the conv's
        bias in x's type, where the conv left it out (in train mode its
        gradient comes back through bn_act)."""
        if not self.training:
            return bn_act_eval(x, conv_bias, self.running_mean,
                               self.running_var, self.weight, self.bias,
                               self.eps, act, dtype)
        y, mean, var = bn_act(x, self.weight, self.bias, self.eps, act,
                              self.group, conv_bias)
        if not getattr(_RECOMPUTE, "active", False):
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var, alpha=self.momentum)
        return y.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x, "none", x.dtype)


def remat(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """fn(*args, generator) with its activations recomputed in the
    backward (torch.utils.checkpoint, non-reentrant). The recomputation
    leaves the BatchNorm running statistics alone and draws dropout from
    a copy of `generator` in the state the first run found, so it
    repeats the first run exactly. Outside autograd fn runs plainly."""
    if not torch.is_grad_enabled():
        return fn(*args, generator)
    state = generator.get_state() if generator is not None else None
    runs = []

    def run(*a):
        if not runs:
            runs.append(1)
            return fn(*a, generator)
        gen = None
        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        with _recomputing():
            return fn(*a, gen)

    return checkpoint(run, *args, use_reentrant=False)


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype,
          transpose: bool = False, bias: bool = True) -> torch.Tensor:
    """The conv in the compute dtype, weights cast from the f32 masters;
    bias=False leaves the bias out."""
    w = conv.weight.to(dtype)
    b = conv.bias.to(dtype) if bias else None
    if transpose:
        return F.conv_transpose2d(x.to(dtype), w, b, stride=conv.stride)
    return F.conv2d(x.to(dtype), w, b, padding=conv.padding)


def _folds_conv_bias(bn: nn.Module, x: torch.Tensor) -> bool:
    """Whether the conv before `bn` leaves its bias to the BatchNorm: on a
    GPU, where ATen adds a cuDNN convolution's bias in a pass of its own
    (and sums its gradient in another), which bn_act_eval's kernel (eval)
    and bn_act's kernels (train) take over. On the CPU oneDNN adds the
    bias inside the conv (in bf16 not the same as adding it to the rounded
    output), so the conv keeps it there. `bn` is not read: it stays for
    the routings patched in its place, which read its mode (the eval-only
    fold of the tests, the routing before the train-mode fold of
    chip_smoke.py's conv_bias_fold gate)."""
    return x.device.type == "cuda"


def conv_bn_act(conv: nn.Module, bn: "BatchNorm", x: torch.Tensor,
                act: str, dtype: torch.dtype) -> torch.Tensor:
    """act(bn(conv(x))) in `dtype`: the conv, then `bn.act`, with the
    conv bias handed to the BatchNorm where `_folds_conv_bias` says so."""
    if _folds_conv_bias(bn, x):
        return bn.act(_conv(conv, x, dtype, bias=False), act, dtype,
                      conv.bias.to(dtype))
    return bn.act(_conv(conv, x, dtype), act, dtype)


class DoubleConv(nn.Module):
    """(conv k -> BN -> ReLU) x2 (the reference's unet.py:6-21)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.conv0 = nn.Conv2d(in_features, features, kernel, padding=pad)
        self.bn0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(features, features, kernel, padding=pad)
        self.bn1 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = conv_bn_act(conv, bn, x, "relu", dtype)
        return x


class Down(nn.Module):
    """MaxPool 2x2 then DoubleConv (unet.py:24-35). A variant names its
    block class `BLOCK` and the block's attribute `BODY` (the parameter
    names models/weights.py maps)."""

    BLOCK, BODY = DoubleConv, "double_conv"

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.add_module(self.BODY, self.BLOCK(in_features, features))

    @property
    def body(self) -> nn.Module:
        """The block after the pool (what remat covers)."""
        return getattr(self, self.BODY)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.body(F.max_pool2d(x, 2), dtype)


def _crop_or_pad_to(x: torch.Tensor, target_h: int, target_w: int):
    """Match spatial dims to the skip tensor with the reference's
    asymmetric pad (unet.py:51-55): amounts (d//2, d - d//2), negative
    values crop. For the 2H+1 transposed-conv output d = -1 gives
    (-1, 0): the leading row and column go."""
    dh = target_h - x.shape[2]
    dw = target_w - x.shape[3]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class Up(nn.Module):
    """Transposed conv k3 s2 (channels halved), crop/pad to the skip,
    concat, DoubleConv (unet.py:38-60).

    The weight of `up` is a torch ConvTranspose2d weight (in, out, kh,
    kw). Flax's ConvTranspose does not flip its kernel, so a Flax kernel
    maps to it flipped on both spatial axes (models/weights.py). `BLOCK`
    and `BODY` as in Down."""

    BLOCK, BODY = DoubleConv, "double_conv"

    def __init__(self, in_features: int, out_features: int, skip: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, in_features // 2, 3,
                                     stride=2)
        self.add_module(self.BODY, self.BLOCK(skip + in_features // 2,
                                              out_features))

    @property
    def body(self) -> nn.Module:
        """The block after the concat (what remat covers)."""
        return getattr(self, self.BODY)

    def upsample(self, x: torch.Tensor, skip: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
        """The transposed conv, cropped to the skip and concatenated."""
        x = _conv(self.up, x, dtype, transpose=True)
        x = _crop_or_pad_to(x, skip.shape[2], skip.shape[3])
        return torch.cat([skip, x.to(skip.dtype)], dim=1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        return self.body(self.upsample(x, skip, dtype), dtype)


def _dropout(x: torch.Tensor, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout at rate OutConv.DROP in train mode: a keep mask (p = 1 -
    DROP, survivors scaled by 1/(1 - DROP)) drawn from `generator`."""
    if not training:
        return x
    drop = OutConv.DROP
    keep = torch.empty_like(x).bernoulli_(1 - drop, generator=generator)
    return x * keep.mul_(1.0 / (1 - drop))          # 0 or 1.25, exact


class OutConv(nn.Module):
    """Conv3x3 -> BN -> LeakyReLU -> Dropout(0.2) -> Conv1x1
    (unet.py:63-74). Dropout is the identity in eval; in train mode the
    keep mask (p = 0.8, survivors scaled by 1/0.8) is drawn from
    `generator` (the device's default generator if None)."""

    DROP = 0.2

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_features, in_features, 3, padding=1)
        self.bn0 = BatchNorm(in_features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(in_features, out_features, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = conv_bn_act(self.conv0, self.bn0, x, "leaky_relu", dtype)
        x = _dropout(x, self.training, generator)
        return _conv(self.conv1, x, dtype)


def head_names(heads: Sequence[int]) -> Tuple[str, ...]:
    return (HEAD_NAMES if len(heads) == len(HEAD_NAMES)
            else tuple(f"head{i}" for i in range(len(heads))))


class _Trunk(nn.Module):
    """What the production U-Net and its variants share: the learned
    uncertainty weights, the encoder from the 64-channel level (x3) down,
    the decoder, the two trailing DoubleConvs, the heads and the serving
    contract of `forward`. A subclass builds its stem in `build_stem`
    (registered right after `s`, so parameters keep the order of the JAX
    module's tree) and maps the NCHW input to x3 in `stem`; a variant's
    blocks are its `DOUBLE_CONV`, `DOWN`, `UP` and `OUT_CONV` classes,
    and `HEAD_DTYPE` (None: the compute dtype) the type its heads come
    back in."""

    BLOCKS = ("down3", "down4", "down5", "up1", "up2", "up3", "dconv1",
              "dconv2")
    DOUBLE_CONV, DOWN, UP, OUT_CONV = DoubleConv, Down, Up, OutConv
    HEAD_DTYPE: Optional[torch.dtype] = None

    def __init__(self, heads: Sequence[int], dtype: torch.dtype,
                 fused_head_bank: bool = False,
                 remat_blocks: Sequence[str] = ()):
        super().__init__()
        self.heads = tuple(heads)
        self.dtype = dtype
        self.head_names = head_names(self.heads)
        self.fused_head_bank = fused_head_bank
        self.remat_blocks = frozenset(remat_blocks)
        # Learned homoscedastic uncertainty weights (unet.py:82).
        self.s = nn.Parameter(torch.randn(10) / 100.0)
        self.build_stem()
        unknown = self.remat_blocks - set(self.BLOCKS) - {"heads"}
        if unknown:
            raise ValueError(f"remat_blocks: no block {sorted(unknown)}")
        self.down3 = self.DOWN(64, 128)
        self.down4 = self.DOWN(128, 256)
        self.down5 = self.DOWN(256, 512)
        self.up1 = self.UP(512, 256, skip=256)
        self.up2 = self.UP(256, 128, skip=128)
        self.up3 = self.UP(128, 128, skip=64)
        self.dconv1 = self.DOUBLE_CONV(128, 128)
        self.dconv2 = self.DOUBLE_CONV(128, 128)
        if fused_head_bank:
            n = len(self.heads)
            self.head_bank = nn.Conv2d(128, 128 * n, 3, padding=1)
            self.head_bank_bn = BatchNorm(128 * n, BN_EPS, BN_MOMENTUM)
            for name, width in zip(self.head_names, self.heads):
                self.add_module(f"out1_{name}", nn.Conv2d(128, width, 1))
        else:
            for name, width in zip(self.head_names, self.heads):
                self.add_module(f"out_{name}", self.OUT_CONV(128, width))

    def head(self, name: str) -> OutConv:
        if self.fused_head_bank:
            raise ValueError("a fused head bank has no per-head OutConv: "
                             "convert the weights with "
                             "models.fuse_heads.unfuse_head_variables")
        return getattr(self, f"out_{name}")

    def build_stem(self) -> None:
        raise NotImplementedError

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _block(self, name: str, fn: Callable, *args):
        """A block's forward, rematerialized if `name` is listed."""
        if name in self.remat_blocks:
            return remat(lambda *a: fn(*a[:-1]), *args)
        return fn(*args)

    def _down(self, name: str, x: torch.Tensor) -> torch.Tensor:
        # As in the JAX module, remat covers a Down's DoubleConv, not its
        # max pool, and an Up's DoubleConv, not its transposed conv.
        block = getattr(self, name)
        return self._block(name, lambda t: block.body(t, self.dtype),
                           F.max_pool2d(x, 2))

    def _up(self, name: str, x: torch.Tensor,
            skip: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        x = block.upsample(x, skip, self.dtype)
        return self._block(name, lambda t: block.body(t, self.dtype), x)

    def _dc(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return self._block(name, lambda t: block(t, self.dtype), x)

    def forward(self, x: torch.Tensor, dense_heads: Sequence[str] = None,
                return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: NHWC (B, H, W, 1). dense_heads: if given, only these heads
        are computed. return_features additionally returns the shared
        NHWC (B, H/4, W/4, 128) trunk features, so callers can evaluate
        the other heads only at peak cells (infer/decode.py). generator:
        the source of the heads' dropout masks in train mode."""
        dt = self.dtype
        x3 = self.stem(x.permute(0, 3, 1, 2).to(dt))
        x4 = self._down("down3", x3)
        x5 = self._down("down4", x4)
        x6 = self._down("down5", x5)
        y = self._up("up1", x6, x5)
        y = self._up("up2", y, x4)
        y = self._up("up3", y, x3)
        y = self._dc("dconv2", self._dc("dconv1", y))

        names = [n for n in self.head_names
                 if dense_heads is None or n in dense_heads]
        if self.fused_head_bank:
            heads = self._fused_heads(y, names, generator)
        else:
            heads = {}
            for name in names:
                head = self.head(name)
                if "heads" in self.remat_blocks:
                    heads[name] = remat(lambda t, g, h=head: h(t, dt, g), y,
                                        generator=generator)
                else:
                    heads[name] = head(y, dt, generator)
        if self.HEAD_DTYPE is not None:
            heads = {n: v.to(self.HEAD_DTYPE) for n, v in heads.items()}
        out = {n: v.permute(0, 2, 3, 1) for n, v in heads.items()}
        if return_features:
            return out, y.permute(0, 2, 3, 1)
        return out

    def _fused_heads(self, y, names, generator):
        """One 3x3 conv of 128·n channels, one BatchNorm over them,
        LeakyReLU, dropout, then each head's 1x1 on its 128 channels
        (unet.py:169-185 of the JAX package)."""
        dt = self.dtype
        yb = conv_bn_act(self.head_bank, self.head_bank_bn, y, "leaky_relu",
                         dt)
        yb = _dropout(yb, self.training, generator)
        # One split, not n slices: its backward is a single concatenation
        # of the heads' gradients, where a slice's backward writes a zero
        # tensor of the whole bank for each head.
        parts = dict(zip(self.head_names, yb.split(128, dim=1)))
        return {n: _conv(getattr(self, f"out1_{n}"), parts[n], dt)
                for n in names}


class UNet(_Trunk):
    """Production multi-head U-Net.

    forward(x) takes NHWC images (B, 512, 512, 1) and returns a dict
    head name -> (B, 128, 128, width) logits in `dtype`."""

    BLOCKS = ("inc1", "inc2", "down1", "down2", "inc3") + _Trunk.BLOCKS

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32,
                 fused_head_bank: bool = False,
                 remat_blocks: Sequence[str] = ()):
        super().__init__(heads, dtype, fused_head_bank, remat_blocks)

    def build_stem(self) -> None:
        self.inc1 = DoubleConv(1, 16)
        self.inc2 = DoubleConv(16, 16)
        self.down1 = Down(16, 32)
        self.down2 = Down(32, 64)
        self.inc3 = DoubleConv(64, 64)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self._dc("inc2", self._dc("inc1", x))
        x2 = self._down("down1", x1)
        return self._dc("inc3", self._down("down2", x2))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
