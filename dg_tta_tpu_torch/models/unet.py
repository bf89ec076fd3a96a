"""nnUNet v2 PlainConvUNet as an `nn.Module`, channels-last.

The port of `dg_tta_tpu/models/unet.py::unet_apply`.  Parameters live in
nnUNet's own modules and names (`encoder.stages.N.0.convs.M.{conv,norm}`,
`decoder.{transpconvs,stages,seg_layers}`), so an nnUNet `state_dict` loads
with `load_state_dict` (`models/convert.py`).  The modules only hold
parameters; `forward` computes on channels-last (B, D, H, W, C) tensors:

* stride-1 3x3x3 convs: one launch of the Hopper kernel
  `kernels/conv3x3.py` each, on a (B*D, H, W, C) view (the JAX package's
  three z-tap 2D convs, summed inside the kernel).  Autograd runs their
  backward through the port's kernels too (`conv3x3_op`: the input gradient
  through the same kernel, the weight gradient through `conv3x3_wgrad`);
* stride-2 stage-entry convs: `F.conv3d` forward, `torch.nn.grad`'s
  conv3d_input / conv3d_weight backward.  This is a library conv for work
  that the JAX package also leaves to XLA, outside any Pallas kernel.
  cuDNN would run it in TF32 under PyTorch's default
  `torch.backends.cudnn.allow_tf32 = True`, ~3 decimal digits, against
  the JAX package's full f32.  So a small `autograd.Function`
  (`_StridedConv3d`) turns that flag off around its forward and around
  its backward, which autograd runs later, outside any block that wrapped
  the forward call, and restores it after each: the port owns no global
  precision state, and bf16 convs do not read the flag;
* transposed convs with kernel == stride: one matmul and a sub-voxel
  interleave, as in the JAX package;
* InstanceNorm with f32 statistics (the E[x^2]-E[x]^2 form under bf16);
* the conv bias before InstanceNorm is skipped: the norm's mean
  subtraction cancels it exactly;
* 1x1x1 heads: a matmul, with `head_channel_idx` selecting output classes.

`forward_members` runs the members of an ensemble chunk side by side, as
the JAX package vmaps them: every parameter carries a leading member axis
M (`stack_members`), and the batch holds member m's samples after member
m - 1's.  `torch.func` cannot vmap the kernels' autograd Functions, so the
member axis is explicit.  Each stride-1 conv is one launch with every
member's weights (`kernels/conv3x3.py`, each member's planes the bits of
its own launch).  The operations that sum across a member's positions
run once per member on that member's samples, as its serial forward runs
them: the stride-2 convs (cuDNN sees one member's shapes, TF32 off),
InstanceNorm, the transposed convs and the heads.  A reduction or a
matmul over the chunk's batch would split its sums by the chunk's size,
and on the card that moved the members' updates 2-3e-2 of their norm off
the serial run's (AdamW's sign steps; PERF.md §6).  The serial
`forward` is the one-member model.
"""

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3_op
from dg_tta_tpu_torch.models.plans import ArchSpec

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None / "float32" -> None (f32); "bfloat16" -> torch.bfloat16 (the
    values of `DGTTA_COMPUTE_DTYPE`)."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {compute_dtype!r}")
    return _DTYPES[compute_dtype]


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, kernel, stride, eps):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride,
                              padding=tuple(k // 2 for k in kernel))
        self.norm = nn.InstanceNorm3d(cout, eps=eps, affine=True)


class StackedConvBlocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.convs = nn.ModuleList(blocks)


class Encoder(nn.Module):
    def __init__(self, spec: ArchSpec):
        super().__init__()
        stages = []
        cin = spec.num_input_channels
        for s in range(spec.n_stages):
            f = spec.features_per_stage[s]
            blocks = []
            for ci in range(spec.n_conv_per_stage_encoder[s]):
                stride = spec.strides[s] if ci == 0 else (1, 1, 1)
                blocks.append(ConvBlock(cin, f, spec.kernel_sizes[s], stride,
                                        spec.norm_eps))
                cin = f
            # nnUNet wraps each encoder stage in a Sequential: `stages.N.0`
            stages.append(nn.Sequential(StackedConvBlocks(blocks)))
        self.stages = nn.ModuleList(stages)


class Decoder(nn.Module):
    def __init__(self, spec: ArchSpec):
        super().__init__()
        f = spec.features_per_stage
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.seg_layers = nn.ModuleList()
        for d in range(spec.n_stages - 1):
            below = f[spec.n_stages - 1 - d]
            here = f[spec.n_stages - 2 - d]
            up = spec.strides[spec.n_stages - 1 - d]
            self.transpconvs.append(nn.ConvTranspose3d(below, here, up, up))
            kernel = spec.kernel_sizes[spec.n_stages - 2 - d]
            self.stages.append(StackedConvBlocks([
                ConvBlock(2 * here if ci == 0 else here, here, kernel,
                          (1, 1, 1), spec.norm_eps)
                for ci in range(spec.n_conv_per_stage_decoder[d])]))
            self.seg_layers.append(nn.Conv3d(here, spec.num_classes, 1))


@contextlib.contextmanager
def _no_tf32():
    """Full f32 in cuDNN convs and in matmuls inside, both flags restored
    after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _per_member(fn, x, *params):
    """fn on each member's samples of x with that member's slice of each
    (M, ...) parameter, the results concatenated in member order."""
    return torch.cat([fn(xm, *pm) for xm, *pm in
                      zip(x.chunk(params[0].shape[0]), *params)])


class _StridedConv3d(torch.autograd.Function):
    """`F.conv3d` of channels-first x whose forward and backward both run
    with cuDNN's TF32 off (module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        with _no_tf32():
            return F.conv3d(x, weight, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        kw = dict(stride=ctx.stride, padding=ctx.padding)
        dx = dw = None
        with _no_tf32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv3d_input(x.shape, weight, dy, **kw)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv3d_weight(x, weight.shape, dy, **kw)
        return dx, dw, None, None


def _conv(x, weight, stride):
    """Bias-free 3D conv of channels-last x with a torch-layout weight
    (O, I, kd, kh, kw), or with M members' weights (M, O, I, kd, kh, kw)
    on x of M members' samples, member after member."""
    kernel = tuple(weight.shape[-3:])
    if tuple(stride) != (1, 1, 1) and weight.dim() == 6:
        # once per member: cuDNN sees one member's shapes
        return _per_member(lambda xm, wm: _conv(xm, wm, stride), x, weight)
    if tuple(stride) != (1, 1, 1):
        # library conv for the strided stage entries, TF32 off (module
        # docstring)
        y = _StridedConv3d.apply(x.permute(0, 4, 1, 2, 3), weight,
                                 tuple(stride),
                                 tuple(k // 2 for k in kernel))
        return y.permute(0, 2, 3, 4, 1).contiguous()
    if kernel not in ((3, 3, 3), (1, 3, 3)):
        raise NotImplementedError(
            f"stride-1 conv kernel {kernel}: the conv3x3 kernel takes 3x3 "
            "planes with 1 or 3 z-taps")
    B, D, H, W, C = x.shape
    # ([M,] kd, 3, 3, I, O): one launch with every member's weights
    wk = weight.movedim((-5, -4), (-1, -2)).contiguous()
    y = conv3x3_op(x.reshape(B * D, H, W, C), wk, depth=D)
    return y.view(B, D, H, W, wk.shape[-1])


def _instance_norm(x, scale, bias, eps):
    """Per (sample, channel) normalization over D, H, W; statistics in f32.
    Under bf16 the elementwise math stays bf16 (E[x^2]-E[x]^2 form), as in
    the JAX package."""
    dims = (1, 2, 3)
    if x.dtype == torch.float32:
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * scale + bias
    mean32 = x.mean(dim=dims, keepdim=True, dtype=torch.float32)
    m2 = x.square().mean(dim=dims, keepdim=True, dtype=torch.float32)
    var = (m2 - mean32.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mean32.to(x.dtype)) * (inv * scale) + bias


def _conv_transpose(x, weight, bias):
    """ConvTranspose3d with kernel == stride on channels-last x: every output
    voxel takes exactly one tap, so it is one matmul and an interleave.
    weight is torch's (I, O, kd, kh, kw)."""
    I, O, kd, kh, kw = weight.shape
    B, D, H, W, _ = x.shape
    wr = weight.permute(0, 2, 3, 4, 1).reshape(I, kd * kh * kw * O)
    y = (x.reshape(-1, I) @ wr).view(B, D, H, W, kd, kh, kw, O)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D * kd, H * kh, W * kw, O)
    return y + bias


class PlainConvUNet(nn.Module):
    def __init__(self, spec: ArchSpec):
        super().__init__()
        self.spec = spec
        self.encoder = Encoder(spec)
        self.decoder = Decoder(spec)
        for tc in self.decoder.transpconvs:
            if tuple(tc.kernel_size) != tuple(tc.stride):
                raise NotImplementedError(
                    "transposed convs with kernel != stride")

    def _block(self, x, blk: ConvBlock, dt):
        x = _conv(x, _cast(blk.conv.weight, dt), blk.conv.stride)
        x = _instance_norm(x, _cast(blk.norm.weight, dt),
                           _cast(blk.norm.bias, dt), self.spec.norm_eps)
        return F.leaky_relu(x, self.spec.leaky_slope)

    def _head(self, h, seg: nn.Conv3d, dt, head_channel_idx):
        return _linear_head(h, _cast(seg.weight, dt), _cast(seg.bias, dt),
                            head_channel_idx)

    def _block_members(self, x, params, prefix, blk: ConvBlock, dt):
        x = _conv(x, _cast(params[prefix + ".conv.weight"], dt),
                  blk.conv.stride)
        eps = self.spec.norm_eps
        x = _per_member(lambda xm, s, b: _instance_norm(xm, s, b, eps), x,
                        _cast(params[prefix + ".norm.weight"], dt),
                        _cast(params[prefix + ".norm.bias"], dt))
        return F.leaky_relu(x, self.spec.leaky_slope)

    def _head_members(self, h, params, prefix, dt, head_channel_idx):
        return _per_member(
            lambda hm, w, b: _linear_head(hm, w, b, head_channel_idx), h,
            _cast(params[prefix + ".weight"], dt),
            _cast(params[prefix + ".bias"], dt))

    def forward_members(self, params: dict, x, deep_supervision: bool = False,
                        compute_dtype=None,
                        head_channel_idx: Optional[Sequence[int]] = None):
        """`forward` of M members side by side (module docstring): params
        {name: (M, *shape)} for every parameter (`stack_members`); x (M *
        b, D, H, W, C_in), member m's b samples after member m - 1's.
        Returns what `forward` returns, member-major along the batch."""
        dt = resolve_compute_dtype(compute_dtype)
        if dt is not None:
            x = x.to(dt)
        skips = []
        h = x
        for s, stage in enumerate(self.encoder.stages):
            for ci, blk in enumerate(stage[0].convs):
                h = self._block_members(
                    h, params, f"encoder.stages.{s}.0.convs.{ci}", blk, dt)
            skips.append(h)

        dec = self.decoder
        seg_outputs = []
        lres = skips[-1]
        for d in range(len(dec.stages)):
            h = _per_member(
                _conv_transpose, lres,
                _cast(params[f"decoder.transpconvs.{d}.weight"], dt),
                _cast(params[f"decoder.transpconvs.{d}.bias"], dt))
            h = torch.cat([h, skips[-(d + 2)]], dim=-1)
            for ci, blk in enumerate(dec.stages[d].convs):
                h = self._block_members(
                    h, params, f"decoder.stages.{d}.convs.{ci}", blk, dt)
            lres = h
            if deep_supervision:
                seg_outputs.append(self._head_members(
                    h, params, f"decoder.seg_layers.{d}", dt,
                    head_channel_idx))
        if deep_supervision:
            return seg_outputs[::-1]
        return self._head_members(lres, params,
                                  f"decoder.seg_layers.{len(dec.stages) - 1}",
                                  dt, head_channel_idx)

    def forward(self, x, deep_supervision: bool = False, compute_dtype=None,
                head_channel_idx: Optional[Sequence[int]] = None):
        """x: (B, D, H, W, C_in).  Returns (B, D, H, W, num_classes) logits
        in the compute dtype, or with deep_supervision the list of
        per-resolution logits, highest resolution first."""
        dt = resolve_compute_dtype(compute_dtype)
        if dt is not None:
            x = x.to(dt)
        skips = []
        h = x
        for stage in self.encoder.stages:
            for blk in stage[0].convs:
                h = self._block(h, blk, dt)
            skips.append(h)

        dec = self.decoder
        seg_outputs = []
        lres = skips[-1]
        for d in range(len(dec.stages)):
            tc = dec.transpconvs[d]
            h = _conv_transpose(lres, _cast(tc.weight, dt), _cast(tc.bias, dt))
            h = torch.cat([h, skips[-(d + 2)]], dim=-1)
            for blk in dec.stages[d].convs:
                h = self._block(h, blk, dt)
            lres = h
            if deep_supervision:
                seg_outputs.append(self._head(h, dec.seg_layers[d], dt,
                                              head_channel_idx))
        if deep_supervision:
            return seg_outputs[::-1]
        return self._head(lres, dec.seg_layers[-1], dt, head_channel_idx)


def _cast(p, dt):
    return p if dt is None else p.to(dt)


def _linear_head(h, weight, bias, head_channel_idx):
    """A 1x1x1 head (torch's (O, I, 1, 1, 1) weight) on channels-last h, the
    output classes `head_channel_idx` (None: all)."""
    w = weight.reshape(weight.shape[0], weight.shape[1])
    if head_channel_idx is not None:
        idx = torch.as_tensor([int(i) for i in head_channel_idx],
                              dtype=torch.long, device=w.device)
        w, bias = w[idx], bias[idx]
    return h @ w.t() + bias


def stack_members(nets) -> dict:
    """{name: (M, *shape)}: the parameters of the M networks `nets`
    stacked along a new leading member axis, as fresh tensors (the input
    of `forward_members`)."""
    per = [dict(n.named_parameters()) for n in nets]
    return {name: torch.stack([p[name].detach() for p in per])
            for name in per[0]}


@torch.no_grad()
def init_unet_(net: PlainConvUNet, generator: torch.Generator):
    """He-normal init (kaiming, a = leaky slope) of every conv weight, the
    JAX package's `init_unet_params` scheme; zero biases, unit norm scales.
    Draws come from `generator` (a CPU generator), so a seed fixes them."""
    gain = (2.0 / (1 + net.spec.leaky_slope ** 2)) ** 0.5

    def he(w, fan_in):
        w.copy_(torch.randn(w.shape, generator=generator) * (gain / fan_in ** 0.5))

    for m in net.modules():
        if isinstance(m, nn.ConvTranspose3d):
            # the JAX layout's fan-in: kernel volume x output channels
            he(m.weight, m.weight.shape[1] * m.weight[0, 0].numel())
            m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            he(m.weight, m.weight[0].numel())
            m.bias.zero_()
        elif isinstance(m, nn.InstanceNorm3d):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return net
