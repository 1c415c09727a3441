"""Conv bias -> BatchNorm -> activation -> cast as one op: train mode
(`bn_act`, an autograd op) and eval mode (`bn_act_eval`, forward only).

`bn_act(x, weight, bias, eps, act, group, conv_bias)` is the port's one
train-mode BatchNorm. It replaces the chain `act(F.batch_norm((x +
conv_bias).float())).to(dtype)`, which adds the conv bias in a pass of
its own, keeps an f32 copy of the conv output and an f32 activation
output for its backward and sums the bias gradient in another pass, with
an op that takes the conv output `x` without its bias, keeps `x` itself
(bf16 in production) and per-channel vectors, recomputes the
normalisation in the backward and returns the bias gradient (in the
bias's type) as the gradient of its `conv_bias` input. The JAX package
gets the same from XLA, which fuses nn.Conv's bias ->
nn.BatchNorm(dtype=f32) -> relu -> astype(bf16) (abcnet_tpu/models/
unet.py:40-48); no Pallas kernel stands behind it.

A CUDA tensor goes through the four kernels of `csrc/bn_act.cu` (stats,
apply, backward sums, backward apply with the bias gradient), which take
channels_last, the layout the port's convolutions run in (the 1-channel
input's NHWC view is both layouts, and the convolutions keep
channels_last from there; another layout is copied to it). y and dx are
channels_last, as the chain's outputs were, so the heads' dropout, which
draws its keep mask in memory order, draws the masks it drew before. A
CPU tensor goes through `bn_act_plain`: `x + conv_bias` in x's type
under autograd, then the former chain's exact op sequence (F.batch_norm
with zeroed scratch buffers and momentum 1) under no_grad, whose
backward runs that sequence again with grad enabled: on any device its
outputs, batch statistics and gradients are those of the chain, bit for
bit.

With a process group of more than one rank (`group`, data parallel) the
statistics are those of the global batch: each rank's (count, mean,
biased variance) is all-gathered between the statistics and the apply and
pooled (the counts weight the means, the spread of the means adds to the
variances), and the backward all-reduces the two sums between its
reduction and its apply. The weight, bias and conv bias gradients stay
this rank's sums; the trainer's gradient all-reduce adds them up.

`bn_act_eval(x, conv_bias, running_mean, running_var, weight, bias, eps,
act, dtype)` is the eval-mode BatchNorm of serving, `eval_step` and the
metrics step: act(F.batch_norm eval(x + conv_bias)) in `dtype`, x the
conv output without its bias. A CUDA tensor goes through kernel (e) of
`csrc/bn_act.cu` (`eval_apply`), one pass that reads x and writes y, in
place of the conv bias add_, .float(), F.batch_norm, the activation and
.to() the port ran before; it has no backward and raises where autograd
would need one. A CPU tensor goes through `bn_act_eval_plain`, which is
that chain.

Each kernel entry point counts its launches (`stats.launches`, ...,
`eval_apply.launches`), as ops/unpack.py does; `launches()` is the sum of
the four train-mode ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils import build
from ..utils.device import stream_ptr

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.01
DTYPES = (torch.bfloat16, torch.float32)
CHANNELS_LAST = torch.channels_last
# The train-mode kernels' split (csrc/bn_act.cu:train_block): the fewest
# pixels a thread row of a block takes, and the most channels a block's
# column holds. The blocks aimed at are those the reduction's kernel has
# resident at once (`_resident`): one wave, so that no block waits for a
# second and each column's last block merges as few partials as that
# allows.
MIN_ROWS = 4
COLUMN = 64
STATS_KIND, SUMS_KIND = 0, 2


def activation(act: str):
    """The activation `act` names, as a function of a tensor."""
    if act == "relu":
        return F.relu
    if act == "leaky_relu":
        return lambda t: F.leaky_relu(t, LEAKY_SLOPE)
    return lambda t: t


def _pooled(count: float, mean: torch.Tensor, var: torch.Tensor, group):
    """The global batch's (mean, biased variance, count) from every rank's
    (count, mean, biased variance), all-gathered in f32."""
    c = mean.numel()
    mine = torch.cat([torch.full((1,), count, dtype=mean.dtype,
                                 device=mean.device), mean, var])
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    g = torch.stack(parts)
    counts, means, vars_ = g[:, :1], g[:, 1:c + 1], g[:, c + 1:]
    n = counts.sum()
    mean = (counts * means).sum(0) / n
    var = (counts * (vars_ + (means - mean) ** 2)).sum(0) / n
    return mean, var, n


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("bn_act")
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    sig = {
        "abcnet_bn_act_stats": [p, p, i, i, ll, ll, i, ll, p, f, p, p],
        "abcnet_bn_act_apply": [p, p, p, i, i, i, ll, ll, i, ll, p, p, p, p],
        "abcnet_bn_act_grad_sums": [p, p, p, i, i, i, ll, ll, i, ll, p, p,
                                    p, p, p, p],
        "abcnet_bn_act_grad_apply": [p, p, p, p, i, i, i, ll, ll, i, ll, p,
                                     p, p, p, f, p, p, p],
        "abcnet_bn_act_eval": [p, p, i, i, i, i, ll, ll, ll, p, p, p, p, p, f,
                               p],
        "abcnet_bn_act_resident": [i, i, i, i],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _shape(x: torch.Tensor) -> Tuple[int, int]:
    """(pixels N*H*W, C) of a CUDA tensor the kernels take; raises on what
    they do not."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_act kernels: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act kernels take bf16 or f32, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=CHANNELS_LAST):
        raise ValueError("bn_act kernels take a channels_last NCHW tensor")
    n, c, h, w = x.shape
    pixels = n * h * w
    if pixels == 0 or pixels >= 2 ** 31:
        raise ValueError(f"bn_act kernels: unsupported shape {tuple(x.shape)}")
    return pixels, c


def _check_vectors(x: torch.Tensor, *vs: torch.Tensor) -> None:
    """The per-channel operands: contiguous f32 on x's device."""
    for v in vs:
        if v.dtype != torch.float32 or v.device != x.device or \
                not v.is_contiguous() or v.shape[-1] != x.shape[1]:
            raise ValueError("bn_act kernels take contiguous f32 per-channel "
                             "vectors on the input's device")


def _check_dy(x: torch.Tensor, dy: torch.Tensor) -> None:
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or \
            not dy.is_contiguous(memory_format=CHANNELS_LAST):
        raise ValueError("bn_act kernels: dy must match x in shape, type, "
                         "device and layout")


def _check_conv_bias(x: torch.Tensor,
                     conv_bias: Optional[torch.Tensor]) -> None:
    """A conv bias is None or C contiguous values of x's type on x's
    device."""
    if conv_bias is None:
        return
    if conv_bias.dtype != x.dtype:
        raise TypeError(f"bn_act: conv_bias must be of x's type {x.dtype}, "
                        f"not {conv_bias.dtype}")
    if x.dim() < 2 or conv_bias.shape != (x.shape[1],) or \
            conv_bias.device != x.device or not conv_bias.is_contiguous():
        raise ValueError("bn_act: conv_bias must be C contiguous values on "
                         "x's device")


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """1 where 16-byte accesses fit (C a multiple of 16 bytes of values,
    every pointer aligned), else 0."""
    return int(c * tensors[0].element_size() % 16 == 0 and
               all(t.data_ptr() % 16 == 0 for t in tensors))


@functools.lru_cache(maxsize=None)
def _resident(device: int, kind: int, bf16: int, vec: int, act: int) -> int:
    """Blocks of train-mode kernel `kind` that `device` holds at once."""
    with torch.cuda.device(device):
        n = _lib().abcnet_bn_act_resident(kind, bf16, vec, act)
    _check(max(0, -n), "occupancy query")
    return max(1, n)


def _split(x: torch.Tensor, c: int, vec: int, kind: int,
           act: str = "none") -> Tuple[int, int]:
    """(P, pixels a chunk) of the train-mode kernels on channels_last x: a
    block covers TX channel vectors of one column of at most COLUMN
    channels (TX as csrc/bn_act.cu:train_block chooses it) and a chunk of
    the pixels, with as many blocks as the reduction's kernel (`kind`)
    has resident on x's device and at least MIN_ROWS pixels a thread
    row."""
    pixels = x.numel() // c
    el = x.element_size()
    target = _resident(x.device.index, kind, int(x.dtype == torch.bfloat16),
                       vec, ACTS[act])
    width = 16 // el if vec else 1
    cv = c // width
    tx = 1
    while tx < cv and tx < COLUMN // width:
        tx *= 2
    across = -(-cv // tx)
    blocks = max(1, min(-(-target // across),
                        -(-pixels // (256 // tx * MIN_ROWS)), 65535))
    chunk = -(-pixels // blocks)
    return -(-pixels // chunk), chunk


def _scratch(x: torch.Tensor, floats: int, c: int) -> torch.Tensor:
    """A reduction's scratch: its f32 block partials, then a 32-bit
    ticket a column (at most c), which the launch zeroes on its
    stream: each call has its own, whatever else runs on the device."""
    return torch.empty(floats + c, dtype=torch.float32, device=x.device)


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"bn_act {what} kernel launch failed (CUDA error "
                           f"{err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stats(x: torch.Tensor, eps: float,
          conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel (a): (3, C) f32 rows mean, biased variance and 1/sqrt(var +
    eps) of channels_last `x` + `conv_bias` (rounded to x's type) per
    channel."""
    _check_conv_bias(x, conv_bias)
    pixels, c = _shape(x)
    vec = _vec(c, x)
    blocks, chunk = _split(x, c, vec, STATS_KIND)
    part = _scratch(x, 2 * c * blocks, c)
    out = torch.empty(3, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_bn_act_stats(
            x.data_ptr(), _ptr(conv_bias), int(x.dtype == torch.bfloat16),
            vec, pixels, c, blocks, chunk, part.data_ptr(), eps,
            out.data_ptr(), stream_ptr(x))
    _check(err, "stats")
    stats.launches += 1
    return out


def apply(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor, act: str,
          conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel (b): act((x + conv_bias - mean) * invstd * weight + bias) in
    x's type, channels_last, with `st` the (3, C) rows of `stats`."""
    _check_conv_bias(x, conv_bias)
    pixels, c = _shape(x)
    _check_vectors(x, st, weight, bias)
    y = torch.empty_like(x)
    vec = _vec(c, x, y)
    blocks, chunk = _split(x, c, vec, STATS_KIND)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_bn_act_apply(
            x.data_ptr(), y.data_ptr(), _ptr(conv_bias),
            int(x.dtype == torch.bfloat16), vec, ACTS[act], pixels, c,
            blocks, chunk, st.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            stream_ptr(x))
    _check(err, "apply")
    apply.launches += 1
    return y


def grad_sums(x: torch.Tensor, dy: torch.Tensor, st: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor, act: str,
              conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel (c): (2, C) f32 rows sum(g) and sum(g * xhat) per channel,
    g = dy * act'(pre), x + conv_bias normalised."""
    _check_conv_bias(x, conv_bias)
    pixels, c = _shape(x)
    _check_vectors(x, st, weight, bias)
    _check_dy(x, dy)
    vec = _vec(c, x, dy)
    blocks, chunk = _split(x, c, vec, SUMS_KIND, act)
    part = _scratch(x, 2 * c * blocks, c)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_bn_act_grad_sums(
            x.data_ptr(), dy.data_ptr(), _ptr(conv_bias),
            int(x.dtype == torch.bfloat16), vec, ACTS[act], pixels, c,
            blocks, chunk, st.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            part.data_ptr(), sums.data_ptr(), stream_ptr(x))
    _check(err, "backward sums")
    grad_sums.launches += 1
    return sums


def grad_apply(x: torch.Tensor, dy: torch.Tensor, st: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, sums: torch.Tensor,
               inv_n: float, act: str,
               conv_bias: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel (d): (dx, dconv_bias). dx = weight * invstd * (g - sums[0] *
    inv_n - xhat * sums[1] * inv_n) in x's type, channels_last;
    dconv_bias, where a conv bias is given (else None), the per-channel
    sum of that dx, summed in f32 and double and rounded to x's type."""
    _check_conv_bias(x, conv_bias)
    pixels, c = _shape(x)
    _check_vectors(x, st, weight, bias, sums)
    _check_dy(x, dy)
    dx = torch.empty_like(x)
    vec = _vec(c, x, dy, dx)
    blocks, chunk = _split(x, c, vec, SUMS_KIND, act)
    part = dbias = None
    if conv_bias is not None:
        part = _scratch(x, c * blocks, c)
        dbias = torch.empty_like(conv_bias)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_bn_act_grad_apply(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _ptr(conv_bias),
            int(x.dtype == torch.bfloat16), vec, ACTS[act], pixels, c,
            blocks, chunk, st.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            sums.data_ptr(), inv_n, _ptr(part), _ptr(dbias), stream_ptr(x))
    _check(err, "backward apply")
    grad_apply.launches += 1
    return dx, dbias


def eval_apply(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
               running_mean: torch.Tensor, running_var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, eps: float,
               act: str) -> torch.Tensor:
    """Kernel (e): act(F.batch_norm eval(x + conv_bias)) in x's type and
    layout, x channels_last or contiguous NCHW (any other layout raises:
    nothing is copied), conv_bias None or C values of x's type."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_act kernels: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act kernels take bf16 or f32, not {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"bn_act_eval kernel: unsupported shape "
                         f"{tuple(x.shape)}")
    cl = x.is_contiguous(memory_format=CHANNELS_LAST)
    if not (cl or x.is_contiguous()):
        raise ValueError("bn_act_eval kernel takes a channels_last or "
                         "contiguous NCHW tensor")
    _check_vectors(x, running_mean, running_var, weight, bias)
    if conv_bias is not None and (
            conv_bias.dtype != x.dtype or conv_bias.device != x.device or
            not conv_bias.is_contiguous() or
            conv_bias.shape != (x.shape[1],)):
        raise ValueError("bn_act_eval kernel: conv_bias must be C contiguous "
                         "values of x's type on x's device")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    # a 16-byte vector holds values of one pixel (channels_last) or of
    # one channel (NCHW): C, or H*W, a multiple of it
    run = c if cl else h * w
    vec = int(run * x.element_size() % 16 == 0 and
              all(t.data_ptr() % 16 == 0 for t in (x, y)))
    with torch.cuda.device(x.device):
        err = _lib().abcnet_bn_act_eval(
            x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), vec,
            ACTS[act], int(cl), x.numel(), c, h * w,
            None if conv_bias is None else conv_bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), eps, stream_ptr(x))
    _check(err, "eval")
    eval_apply.launches += 1
    return y


KERNELS = (stats, apply, grad_sums, grad_apply)
for _k in KERNELS + (eval_apply,):
    _k.launches = 0


def launches() -> int:
    """Launches of the four train-mode kernels since their counts were
    last zeroed (the eval kernel's are `eval_apply.launches`)."""
    return sum(k.launches for k in KERNELS)


def reset_launches() -> None:
    for k in KERNELS + (eval_apply,):
        k.launches = 0


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

def _plain_forward(x, weight, bias, eps, act, group):
    """(y, (3, C) rows mean, biased var and invstd, global count or None)
    by the plain op sequence."""
    xf = x.float()
    c = x.shape[1]
    if group is None:
        mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        var = torch.zeros(c, dtype=torch.float32, device=x.device)
        out = F.batch_norm(xf, mean, var, weight, bias, True, 1.0, eps)
        n = x.numel() // c
        var = var * ((n - 1) / n)     # F.batch_norm leaves the unbiased one
        n_all = None
    else:
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        mean, var, n_all = _pooled(x.numel() // c, mean_l, var_l, group)
        out = (xf - _per_channel(mean)) * _per_channel(
            torch.rsqrt(var + eps) * weight) + _per_channel(bias)
    y = activation(act)(out).to(x.dtype)
    return y, torch.stack([mean, var, torch.rsqrt(var + eps)]), n_all


def _plain_backward(ctx, dy):
    x, weight, bias, st, _ = ctx.saved_tensors
    act, eps, group = ctx.act, ctx.eps, ctx.group
    if group is None:
        with torch.enable_grad():
            xf = x.detach().float().requires_grad_(True)
            w = weight.detach().requires_grad_(True)
            b = bias.detach().requires_grad_(True)
            c = x.shape[1]
            out = F.batch_norm(xf, torch.zeros(c, device=x.device),
                               torch.zeros(c, device=x.device), w, b, True,
                               1.0, eps)
            y = activation(act)(out).to(x.dtype)
            dx, dw, db = torch.autograd.grad(y, (xf, w, b), dy)
        return dx.to(x.dtype), dw, db
    mean, invstd = st[0], st[2]
    xf = x.float()
    with torch.enable_grad():
        out = ((xf - _per_channel(mean)) * _per_channel(invstd * weight)
               + _per_channel(bias)).requires_grad_(True)
        g, = torch.autograd.grad(activation(act)(out).to(x.dtype), out, dy)
    xhat = (xf - _per_channel(mean)) * _per_channel(invstd)
    sums = torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
    local = sums.clone()
    dist.all_reduce(sums, group=group)
    c = x.shape[1]
    g_dy, g_dyx = sums[:c] / ctx.n, sums[c:] / ctx.n
    dx = _per_channel(weight * invstd) * (
        g - _per_channel(g_dy) - xhat * _per_channel(g_dyx))
    return dx.to(x.dtype), local[c:], local[:c]


class _BnAct(torch.autograd.Function):
    """Saves x (the conv output without its bias, in its own type), the
    weight, bias and conv bias, and the (3, C) rows mean, biased variance
    and invstd: nothing of activation size in f32. The plain path takes
    no conv bias (bn_act_plain adds it in front, under autograd)."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv_bias, eps, act, group, plain):
        ctx.act, ctx.eps, ctx.group, ctx.plain = act, eps, group, plain
        ctx.n = None
        if plain:
            y, st, ctx.n = _plain_forward(x, weight, bias, eps, act, group)
        else:
            x = x.contiguous(memory_format=CHANNELS_LAST)
            st = stats(x, eps, conv_bias)
            if group is not None:
                n, c, h, w = x.shape
                mean, var, ctx.n = _pooled(n * h * w, st[0], st[1], group)
                st = torch.stack([mean, var, torch.rsqrt(var + eps)])
            y = apply(x, st, weight, bias, act, conv_bias)
        ctx.save_for_backward(x, weight, bias, st, conv_bias)
        mean, var = st[0], st[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        if ctx.plain:
            dx, dw, db = _plain_backward(ctx, dy)
            return dx, dw, db, None, None, None, None, None
        x, weight, bias, st, conv_bias = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous(memory_format=CHANNELS_LAST)
        sums = grad_sums(x, dy, st, weight, bias, ctx.act, conv_bias)
        local = sums
        if ctx.group is None:
            inv_n = 1.0 / (x.numel() // x.shape[1])
        else:
            sums = sums.clone()
            dist.all_reduce(sums, group=ctx.group)
            sums = sums / ctx.n
            inv_n = 1.0
        dx, dcb = grad_apply(x, dy, st, weight, bias, sums, inv_n, ctx.act,
                             conv_bias)
        return dx, local[1], local[0], dcb, None, None, None, None


def _group(group):
    return group if group is not None and dist.get_world_size(group) > 1 \
        else None


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float, act: str, group=None,
           conv_bias: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(act(weight * xhat + bias) in x's type, batch mean, biased batch
    variance) of NCHW `x` + `conv_bias` in train mode, xhat normalised
    with the batch statistics in f32. `conv_bias`: None, or the bias of
    the conv that made x without it, C values of x's type, added in f32
    and rounded to x's type; its gradient, this rank's per-channel sum of
    dx in its type, flows back through autograd. `act`: "relu",
    "leaky_relu" (slope 0.01) or "none". `group`: the process group of a
    data-parallel run (statistics of the global batch). The mean and
    variance are not differentiable.

    A CUDA tensor goes through the kernels, launched on its device, a CPU
    tensor through `bn_act_plain`; anything else raises."""
    if act not in ACTS:
        raise ValueError(f"bn_act: act {act!r} is none of {sorted(ACTS)}")
    _check_conv_bias(x, conv_bias)
    if x.device.type == "cpu":
        return bn_act_plain(x, weight, bias, eps, act, group, conv_bias)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {x.device}")
    return _BnAct.apply(x, weight, bias, conv_bias, eps, act, _group(group),
                        False)


def bn_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float, act: str, group: Optional[object] = None,
                 conv_bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `bn_act`, on any device: `x + conv_bias` in x's
    type under autograd (which gives the conv bias its gradient), then the
    chain `act(F.batch_norm(x.float(), zeros, zeros, weight, bias, True,
    1.0, eps)).to(x.dtype)` under no_grad (with a group: the pooled
    statistics and the normalisation written out), the backward that
    chain again with grad enabled and torch.autograd.grad (with a group:
    the two sums all-reduced between the reduction and the apply)."""
    if act not in ACTS:
        raise ValueError(f"bn_act: act {act!r} is none of {sorted(ACTS)}")
    _check_conv_bias(x, conv_bias)
    if conv_bias is not None:
        x = x + conv_bias[:, None, None]
    return _BnAct.apply(x, weight, bias, None, eps, act, _group(group), True)


def bn_act_eval(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                running_mean: torch.Tensor, running_var: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, eps: float,
                act: str, dtype: torch.dtype) -> torch.Tensor:
    """act(weight * (xb - running_mean) / sqrt(running_var + eps) + bias)
    in `dtype` and x's layout, xb = x + conv_bias rounded to x's type (x
    alone where conv_bias is None): the eval-mode BatchNorm of a conv
    output x given without its bias.

    A CUDA tensor goes through kernel (e) (`dtype` must be x's type; it
    has no backward, so a call that autograd would track raises: run eval
    forwards under torch.no_grad()), a CPU tensor through
    `bn_act_eval_plain`; anything else raises."""
    if act not in ACTS:
        raise ValueError(f"bn_act: act {act!r} is none of {sorted(ACTS)}")
    if x.device.type == "cpu":
        return bn_act_eval_plain(x, conv_bias, running_mean, running_var,
                                 weight, bias, eps, act, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_eval: unsupported device {x.device}")
    if dtype != x.dtype:
        raise TypeError(f"bn_act_eval kernel writes x's type {x.dtype}, "
                        f"not {dtype}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, conv_bias, weight, bias)):
        raise RuntimeError("bn_act_eval has no backward: run eval-mode "
                           "forwards under torch.no_grad()")
    return eval_apply(x, conv_bias, running_mean, running_var, weight, bias,
                      eps, act)


def bn_act_eval_plain(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      act: str, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `bn_act_eval`, on any device, differentiable: the
    chain x + conv_bias (in x's type) -> .float() -> F.batch_norm(...,
    training=False) -> the activation -> .to(dtype)."""
    if act not in ACTS:
        raise ValueError(f"bn_act: act {act!r} is none of {sorted(ACTS)}")
    if conv_bias is not None:
        x = x + conv_bias[:, None, None]
    out = F.batch_norm(x.float(), running_mean, running_var, weight, bias,
                       False, 0.0, eps)
    return activation(act)(out).to(dtype)
