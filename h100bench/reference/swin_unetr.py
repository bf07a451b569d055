"""Swin UNETR v1 in plain PyTorch, float32, channels-first (N, C, X, Y, Z).

The published network (Hatamizadeh et al. 2022, arXiv:2201.01266, as
MONAI's ``monai.networks.nets.SwinUNETR`` builds it with ``use_v2=False``),
written out step by step as MONAI writes it: the stride-2 patch
embedding; per stage, blocks of ``x + proj(WindowAttention(LN1(x)))`` and
``x + MLP(LN2(x))``, where LN1's output is zero-padded at the end to whole
windows, rolled by minus half a window in every second block (an axis no
longer than the window takes it whole, unshifted), cut into windows,
attended with the relative-position bias (its ``[:n, :n]`` slice where a
window holds n < w^3 tokens) and, when shifted, the -100 region mask, then
put back, rolled back and cropped; patch merging of the eight 2x2x2
neighbours in z, y, x order; the affine-free LayerNorm of the embedding
and of every stage's output; UNETR's residual conv blocks (InstanceNorm
without affine, LeakyReLU 0.01), its up blocks (2^3 stride-2 transposed
conv, then the skip concatenated) and a 1x1x1 head.  Every score and
probability is materialised: it is the reference, not the program.

Parameters live in a flat dict keyed by MONAI's state-dict names.
``quant`` (identity by default) is applied to the operands of every
convolution, Linear layer and attention matrix product: the precision
control passes a rounding to a lower precision there.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str, int]  # name, shape, kind, fan in
EPS = 1e-5
SLOPE = 0.01
MASK = -100.0


def _stages(cfg: dict) -> List[Tuple[int, int, int]]:
    """(width, depth, heads) of each stage."""
    fs = int(cfg["feature_size"])
    return [(fs * 2 ** i, int(d), int(h))
            for i, (d, h) in enumerate(zip(cfg["depths"], cfg["num_heads"]))]


def _res_specs(prefix: str, c_in: int, c_out: int) -> List[Spec]:
    out = [(f"{prefix}.conv1.conv.weight", (c_out, c_in, 3, 3, 3), "conv", 27 * c_in),
           (f"{prefix}.conv2.conv.weight", (c_out, c_out, 3, 3, 3), "conv", 27 * c_out)]
    if c_in != c_out:
        out.append((f"{prefix}.conv3.conv.weight", (c_out, c_in, 1, 1, 1), "conv", c_in))
    return out


def param_specs(cfg: dict) -> List[Spec]:
    """(name, shape, kind, fan in) of every parameter, in the state dict's
    order."""
    fs, c_in, p = int(cfg["feature_size"]), int(cfg["in_channels"]), int(cfg["patch_size"])
    w, ratio = int(cfg["window_size"]), int(cfg["mlp_ratio"])
    pe = c_in * p ** 3
    specs: List[Spec] = [("swinViT.patch_embed.proj.weight", (fs, c_in, p, p, p), "conv", pe),
                         ("swinViT.patch_embed.proj.bias", (fs,), "conv", pe)]
    for i, (c, depth, heads) in enumerate(_stages(cfg)):
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            specs += [(f"{b}.norm1.weight", (c,), "ln_weight", 0),
                      (f"{b}.norm1.bias", (c,), "ln_bias", 0),
                      (f"{b}.attn.relative_position_bias_table", ((2 * w - 1) ** 3, heads),
                       "table", 0),
                      (f"{b}.attn.qkv.weight", (3 * c, c), "linear", c),
                      (f"{b}.attn.qkv.bias", (3 * c,), "linear", c),
                      (f"{b}.attn.proj.weight", (c, c), "linear", c),
                      (f"{b}.attn.proj.bias", (c,), "linear", c),
                      (f"{b}.norm2.weight", (c,), "ln_weight", 0),
                      (f"{b}.norm2.bias", (c,), "ln_bias", 0),
                      (f"{b}.mlp.linear1.weight", (ratio * c, c), "linear", c),
                      (f"{b}.mlp.linear1.bias", (ratio * c,), "linear", c),
                      (f"{b}.mlp.linear2.weight", (c, ratio * c), "linear", ratio * c),
                      (f"{b}.mlp.linear2.bias", (c,), "linear", ratio * c)]
        specs += [(f"{pre}.downsample.norm.weight", (8 * c,), "ln_weight", 0),
                  (f"{pre}.downsample.norm.bias", (8 * c,), "ln_bias", 0),
                  (f"{pre}.downsample.reduction.weight", (2 * c, 8 * c), "linear", 8 * c)]
    for name, ci, co in (("encoder1", c_in, fs), ("encoder2", fs, fs),
                         ("encoder3", 2 * fs, 2 * fs), ("encoder4", 4 * fs, 4 * fs),
                         ("encoder10", 16 * fs, 16 * fs)):
        specs += _res_specs(f"{name}.layer", ci, co)
    for name, ci, co in (("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
                         ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs),
                         ("decoder1", fs, fs)):
        # torch's fan in of a transposed conv: dim 1 of its weight x kernel volume
        specs.append((f"{name}.transp_conv.conv.weight", (ci, co, 2, 2, 2), "conv", 8 * co))
        specs += _res_specs(f"{name}.conv_block", 2 * co, co)
    c_out = int(cfg["out_channels"])
    specs += [("out.conv.conv.weight", (c_out, fs, 1, 1, 1), "conv", fs),
              ("out.conv.conv.bias", (c_out,), "conv", fs)]
    return specs


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in param_specs(cfg))


def init_from_uniform(cfg: dict, u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fp32 parameters from one flat U[0, 1) draw ``u``: convolutions
    and Linear layers U(-1/sqrt(fan_in), +), the bias tables 0.02 x
    U(-sqrt 3, +sqrt 3) (std 0.02), LayerNorm weight 1 + 0.1 U(-1, 1) and
    bias 0.1 U(-1, 1), so every leaf is drawn and no two coincide."""
    params, at = {}, 0
    for name, shape, kind, fan in param_specs(cfg):
        n = math.prod(shape)
        s = 2.0 * u[at:at + n].view(shape) - 1.0
        at += n
        if kind in ("conv", "linear"):
            params[name] = s / math.sqrt(fan)
        elif kind == "table":
            params[name] = 0.02 * math.sqrt(3.0) * s
        elif kind == "ln_weight":
            params[name] = 1.0 + 0.1 * s
        else:
            params[name] = 0.1 * s
    return params


def _window(extent, w: int, shift: int):
    ws = [e if e <= w else w for e in extent]
    ss = [0 if e <= w else shift for e in extent]
    return ws, ss


def _partition(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, n, C)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def _reverse(windows: torch.Tensor, ws, b: int, dims) -> torch.Tensor:
    d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def _mask(dims, ws, ss, device) -> torch.Tensor:
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    win = _partition(img, ws).squeeze(-1)
    m = win.unsqueeze(1) - win.unsqueeze(2)
    return m.masked_fill(m != 0, MASK).masked_fill(m == 0, 0.0)


def _position_index(w: int, device) -> torch.Tensor:
    r = torch.arange(w, device=device)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 2] += w - 1
    rel[:, :, 0] *= (2 * w - 1) * (2 * w - 1)
    rel[:, :, 1] *= 2 * w - 1
    return rel.sum(-1)


def _ln(x, p, pre):
    return F.layer_norm(x, x.shape[-1:], p[f"{pre}.weight"], p[f"{pre}.bias"], EPS)


def _linear(x, p, pre, q):
    return F.linear(q(x), q(p[f"{pre}.weight"]), p.get(f"{pre}.bias"))


def _attention(x, p, pre, heads: int, w: int, mask, q):
    bw, n, c = x.shape
    d = c // heads
    qkv = _linear(x, p, f"{pre}.qkv", q).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    qs, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    a = q(qs) @ q(k).transpose(-2, -1)
    idx = _position_index(w, x.device)[:n, :n].reshape(-1)
    bias = p[f"{pre}.relative_position_bias_table"][idx].reshape(n, n, -1).permute(2, 0, 1)
    a = a + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        a = a.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        a = a.view(-1, heads, n, n)
    a = torch.softmax(a, dim=-1)
    o = (q(a) @ q(v)).transpose(1, 2).reshape(bw, n, c)
    return _linear(o, p, f"{pre}.proj", q)


def _block(x, p, pre, heads: int, w: int, shift: int, q):
    b, d, h, wd, c = x.shape
    ws, ss = _window((d, h, wd), w, shift)
    y = _ln(x, p, f"{pre}.norm1")
    pads = [(ws[i] - e % ws[i]) % ws[i] for i, e in enumerate((d, h, wd))]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = y.shape[1:4]
    mask = None
    if any(s > 0 for s in ss):
        y = torch.roll(y, shifts=(-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
        mask = _mask(dims, ws, ss, x.device)
    o = _attention(_partition(y, ws), p, f"{pre}.attn", heads, w, mask, q)
    y = _reverse(o, ws, b, dims)
    if any(s > 0 for s in ss):
        y = torch.roll(y, shifts=(ss[0], ss[1], ss[2]), dims=(1, 2, 3))
    x = x + y[:, :d, :h, :wd, :]
    m = _linear(F.gelu(_linear(_ln(x, p, f"{pre}.norm2"), p, f"{pre}.mlp.linear1", q)),
                p, f"{pre}.mlp.linear2", q)
    return x + m


def _merge(x, p, pre, q):
    x = torch.cat([x[:, i::2, j::2, k::2, :]
                   for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
    return _linear(_ln(x, p, f"{pre}.norm"), p, f"{pre}.reduction", q)


def _proj_out(x):
    """(B, D, H, W, C) -> the affine-free LayerNorm, (B, C, D, H, W)."""
    return F.layer_norm(x, x.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3)


def _swin(cfg, p, x, q) -> List[torch.Tensor]:
    pt, w = int(cfg["patch_size"]), int(cfg["window_size"])
    x = F.conv3d(q(x), q(p["swinViT.patch_embed.proj.weight"]),
                 p["swinViT.patch_embed.proj.bias"], stride=pt).permute(0, 2, 3, 4, 1)
    out = [_proj_out(x)]
    for i, (_, depth, heads) in enumerate(_stages(cfg)):
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            x = _block(x, p, f"{pre}.blocks.{j}", heads, w, 0 if j % 2 == 0 else w // 2, q)
        x = _merge(x, p, f"{pre}.downsample", q)
        out.append(_proj_out(x))
    return out


def _inorm(x):
    return F.instance_norm(x, eps=EPS)


def _res(p, pre, x, q):
    y = F.conv3d(q(x), q(p[f"{pre}.conv1.conv.weight"]), padding=1)
    y = F.leaky_relu(_inorm(y), SLOPE)
    y = _inorm(F.conv3d(q(y), q(p[f"{pre}.conv2.conv.weight"]), padding=1))
    r = x
    if f"{pre}.conv3.conv.weight" in p:
        r = _inorm(F.conv3d(q(x), q(p[f"{pre}.conv3.conv.weight"])))
    return F.leaky_relu(y + r, SLOPE)


def _up(p, pre, x, skip, q):
    y = F.conv_transpose3d(q(x), q(p[f"{pre}.transp_conv.conv.weight"]), stride=2)
    return _res(p, f"{pre}.conv_block", torch.cat((y, skip), dim=1), q)


def forward(cfg: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """fp32 logits (N, out_channels, X, Y, Z) of fp32 input (N, C, X, Y, Z)."""
    q = quant or (lambda t: t)
    x = x.float()
    hs = _swin(cfg, p, x, q)
    enc0 = _res(p, "encoder1.layer", x, q)
    enc1 = _res(p, "encoder2.layer", hs[0], q)
    enc2 = _res(p, "encoder3.layer", hs[1], q)
    enc3 = _res(p, "encoder4.layer", hs[2], q)
    dec = _res(p, "encoder10.layer", hs[4], q)
    dec = _up(p, "decoder5", dec, hs[3], q)
    dec = _up(p, "decoder4", dec, enc3, q)
    dec = _up(p, "decoder3", dec, enc2, q)
    dec = _up(p, "decoder2", dec, enc1, q)
    dec = _up(p, "decoder1", dec, enc0, q)
    return F.conv3d(q(dec), q(p["out.conv.conv.weight"]), p["out.conv.conv.bias"])


def dice_ce_loss(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Soft Dice of the softmax pooled over the batch (per class, its
    denominator clamped at 1e-5, 1 - dice averaged over the classes) plus
    the voxels' mean cross-entropy, weights 1 each (MONAI's DiceCELoss
    defaults); ``classes`` (N, X, Y, Z) integer class maps."""
    logits = logits.float()
    p = torch.softmax(logits, dim=1)
    t = F.one_hot(classes.long(), logits.shape[1]).movedim(-1, 1).float()
    dims = (0, 2, 3, 4)
    dice = 2.0 * (p * t).sum(dims) / (p + t).sum(dims).clamp_min(1e-5)
    return (1.0 - dice).mean() + F.cross_entropy(logits, classes.long())
