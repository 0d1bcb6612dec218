"""Whole-layer LN-LSTM: the hand-written Hopper kernels (the forward in
csrc/lstm_layer_cluster.cu, with csrc/lstm_layer.cu for H % 4 != 0;
csrc/lstm_layer_bwd_v2.cu, csrc/lstm_layer_bwd_v1.cu), their plain PyTorch
versions, and the torch.autograd.Function that joins forward and backward.

Counterpart of di_hpc_tpu/pallas_kernels/lstm_cell.py, same arguments and
the same functions:

  - `lstm_layer_fused` ~ `lstm_layer_fused` with its custom VJP: the x-side
    LayerNorm and the bias act on the RAW x @ Wx projection, and both
    LayerNorms take one-pass statistics clamped at zero variance.  When a
    gradient is needed it runs `_LayerFunction`: the forward in stash mode
    (`lstm_layer_stash`, also writing the cell-state sequence), and a
    backward through `lstm_layer_bwd_v2` (B >= 64) or `lstm_layer_bwd_v1`
    (B < 64), as `_layer_bwd` routes.  The rest of the backward is plain
    tensor code on either device, as the JAX package leaves it to XLA.
  - `lstm_layer_bwd_v2` ~ `_bwd_impl_v2` (`_bwd_kernel_v2`): the reverse
    loop that recomputes gh_pre = h_{t-1} @ Wh, both LayerNorms, the gates
    and c_t, and returns d(gxp), d(gh_pre) and the parameter sums.
  - `lstm_layer_bwd_v1` ~ `_bwd_impl` (`_bwd_kernel`): the reverse loop over
    precomputed gx and gh_pre streams, returning d(gate) and d(gh_pre).

The TPU kernels' dispatch gates (VMEM budgets, H % 128, S >= 8) are facts
about the TPU and are not carried over: the CUDA kernels take any S >= 1 --
S = 1 is the serving step -- and any H whose shared-memory plan fits one
CTA (the backward kernels also need H % 4 == 0).  The forward routes by
shape (`layer_launch_shape`): H % 4 == 0 runs a thread-block cluster per
group of rows with h @ Wh on the tensor cores, any other H a kernel with
one CTA per 8 rows.

Streams are float32 or bfloat16, as the TPU kernels take them: with bf16,
gxp, Wh, the (4H,) vectors, the state and every stream are bf16 while the
carries, the gate math, the LayerNorm statistics and V2's parameter sums
are float32 (V1's gh_pre stream too).  The plain versions take the same
types with the same rounding points: h (and V2's recomputed h_{t-1}, and
the dh carry's dg_pre) enter their products rounded to the stream type and
widened, `h.to(dt).float() @ wh.float()` -- exact products, float32 sums,
the kernel's product (a bf16 `torch.matmul` would round its output) -- and
every stored output is the float32 value rounded once.  For float32 every
cast is the identity.  Each wrapper dispatches on gxp's dtype to the
`_f32` or `_bf16` entry point and counts the launch in `launches` or
`launches_bf16`, the launch call inside the span `dihpc.kernel.<wrapper>`
(`..._bf16`; utils.profiling.span).
"""

from __future__ import annotations

import torch

from ..utils.constants import LAYERNORM_EPS
from ..utils.profiling import span
from . import _build

__all__ = [
    "lstm_layer_fused", "lstm_layer_plain", "lstm_layer_stash",
    "lstm_layer_stash_plain", "lstm_layer_bwd_v2", "lstm_layer_bwd_v2_plain",
    "lstm_layer_bwd_v1", "lstm_layer_bwd_v1_plain",
    "lstm_layer_bwd_v1_streams", "layer_launch_shape", "v2_launch_shape",
    "v1_launch_shape", "V2_MIN_BATCH",
]

# The backward runs V2 from this batch size up, as lstm_cell.py:_bwd_fits_v2
# routes (its VMEM half is a TPU fact and is not carried over).
V2_MIN_BATCH = 64

# The stream types the kernels are built for.
STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _ln_stats(x: torch.Tensor):
    """One-pass statistics, var clamped at 0 (lstm_cell.py:_ln_stats)."""
    m = x.mean(dim=-1, keepdim=True)
    m2 = (x * x).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp_min(m2 - m * m, 0.0) + LAYERNORM_EPS)
    return m, rstd


def _ln(x, gamma, beta):
    mean, rstd = _ln_stats(x)
    return (x - mean) * rstd * gamma + beta


def _ln_bwd(dy, gamma, xhat, rstd):
    """LayerNorm backward over the last axis, from the normalized input."""
    dxhat = dy * gamma
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


def _gates(gate, H):
    sfo = torch.sigmoid(gate[..., :3 * H])
    return (sfo[..., :H], sfo[..., H:2 * H], sfo[..., 2 * H:3 * H],
            torch.tanh(gate[..., 3 * H:]))


# ---------------------------------------------------------------- forward --

def lstm_layer_stash_plain(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                           norm: bool = True):
    """The forward kernel's function in plain PyTorch (ordinary autograd),
    for float32 or bf16 streams (the module docstring gives the rounding
    points).  Returns (y (S, B, H), c_seq (S, B, H), h_n (B, H), c_n (B,
    H)) in gxp's dtype."""
    H = wh.shape[0]
    dt = gxp.dtype
    wh = wh.float()
    glnx, blnx, gln, bln, bias = (v.float()
                                  for v in (glnx, blnx, gln, bln, bias))
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(gxp.shape[0]):
        x = gxp[t].float()
        gx = _ln(x, glnx, blnx) + bias if norm else x + bias
        gh = h.to(dt).float() @ wh
        if norm:
            gh = _ln(gh, gln, bln)
        si, sf, so, su = _gates(gx + gh, H)
        c = sf * c + si * su
        h = so * torch.tanh(c)
        ys.append(h.to(dt))
        cs.append(c.to(dt))
    return torch.stack(ys), torch.stack(cs), h.to(dt), c.to(dt)


def lstm_layer_plain(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                     norm: bool = True):
    """`lstm_layer_stash_plain` without the cell-state sequence.
    Returns (y (S, B, H), h_n (B, H), c_n (B, H))."""
    y, _, hn, cn = lstm_layer_stash_plain(gxp, wh, glnx, blnx, gln, bln,
                                          bias, h0, c0, norm)
    return y, hn, cn


def lstm_layer_stash(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                     norm: bool = True):
    """The forward in stash mode: (y, c_seq, h_n, c_n), where c_seq (S, B,
    H) is the cell state after every step (lstm_cell.py:_layer_impl with
    stash=True).  CPU tensors run the plain version; CUDA tensors launch the
    forward kernel (counted in `lstm_layer_fused.launches`) or raise."""
    args = (gxp, wh, glnx, blnx, gln, bln, bias, h0, c0)
    if _build.on_cpu(*args):
        return lstm_layer_stash_plain(*args, norm=norm)
    return _lstm_layer_cuda(*args, norm=norm, stash=True)


def lstm_layer_fused(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                     norm: bool = True):
    """One LSTM layer over a full sequence, the time loop inside one kernel.

    Args:
      gxp: (S, B, 4H) RAW input projection x @ Wx.
      wh: (H, 4H) recurrent weights.
      glnx, blnx: (4H,) LayerNorm params for the x-projection.
      gln, bln: (4H,) LayerNorm params for the h-projection.
        (All four are ignored when norm=False -- pass ones/zeros.)
      bias: (4H,) gate bias.
      h0, c0: (B, H) initial state.

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (float32 or bf16, all of one type, contiguous) or raise.  When grad is
    enabled and an input requires it, the call goes through
    `_LayerFunction` on either device, whose backward is the hand-derived
    one (the kernels on the card, their plain versions on the CPU);
    otherwise the forward runs without the stash.  Returns (y (S, B, H),
    h_n, c_n)."""
    args = (gxp, wh, glnx, blnx, gln, bln, bias, h0, c0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LayerFunction.apply(*args, norm)
    if _build.on_cpu(*args):
        return lstm_layer_plain(*args, norm=norm)
    y, _, hn, cn = _lstm_layer_cuda(*args, norm=norm, stash=False)
    return y, hn, cn


lstm_layer_fused.launches = 0
lstm_layer_fused.launches_bf16 = 0


def _stream_dtype(name, gxp) -> torch.dtype:
    if gxp.dtype not in STREAM_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"streams; gxp is {gxp.dtype}")
    return gxp.dtype


def _entry(lib, base, dtype):
    """The C launch function of `base` for the stream dtype."""
    return getattr(lib, base + ("_bf16" if dtype == torch.bfloat16
                                else "_f32"))


def _expect_shapes(name, shapes: dict) -> None:
    """shapes: argument name -> (tensor, expected shape)."""
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {arg} must be {tuple(want)}; got "
                             f"{tuple(t.shape)}")


def _check_smem(name, nbytes, H, device) -> None:
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if nbytes > limit:
        raise ValueError(f"{name}: H={H} needs {nbytes} bytes of shared "
                         f"memory per CTA, over this card's {limit}")


def _layer_dims(name, gxp, wh):
    """(S, B, H) of a (S, B, 4H) stream and (H, 4H) weights, or raise."""
    if gxp.ndim != 3 or wh.ndim != 2:
        raise ValueError(f"{name}: gxp must be (S, B, 4H) and wh (H, 4H); got "
                         f"{tuple(gxp.shape)} and {tuple(wh.shape)}")
    S, B, G = gxp.shape
    H = wh.shape[0]
    if G != 4 * H or tuple(wh.shape) != (H, G) or S < 1 or B < 1:
        raise ValueError(f"{name}: gxp {tuple(gxp.shape)} and wh "
                         f"{tuple(wh.shape)} must be (S>=1, B>=1, 4H) and "
                         f"(H, 4H)")
    return S, B, H


def _launch(wrapper, dtype, fn, device, *args) -> None:
    """Call a C launch function on the current stream of `device` inside
    the span `dihpc.kernel.<wrapper>` (`..._bf16` for bf16 streams), raise
    on a refused launch, and count the launch in the wrapper's `launches`
    or `launches_bf16`."""
    name = wrapper.__name__
    bf16 = dtype == torch.bfloat16
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        with span("dihpc.kernel." + name + ("_bf16" if bf16 else "")):
            status = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                          for a in args), stream)
    _build.check_status(name, status)
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _lstm_layer_cuda(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, norm,
                     stash, rows=None):
    """The forward kernel's launch.  `rows` (8, 16 or 24; H % 4 == 0 only)
    overrides the cluster kernel's rows per group, to measure the
    candidates; by default the library chooses (`layer_launch_shape`)."""
    name = "lstm_layer_fused"
    names = ("gxp", "wh", "glnx", "blnx", "gln", "bln", "bias", "h0", "c0")
    args = (gxp, wh, glnx, blnx, gln, bln, bias, h0, c0)
    dt = _stream_dtype(name, gxp)
    _build.check_kernel_inputs(name, dict(zip(names, args)),
                               aligned=("gxp", "wh"),
                               dtypes=dict.fromkeys(names, dt))
    S, B, H = _layer_dims(name, gxp, wh)
    G = 4 * H
    _expect_shapes(name, {**{n: (t, (G,)) for n, t in
                             zip(names[2:7], args[2:7])},
                          "h0": (h0, (B, H)), "c0": (c0, (B, H))})
    lib = _build.library().cdll
    item = gxp.element_size()
    _check_smem(name, lib.lstm_layer_smem_bytes(H, item), H, gxp.device)

    y = torch.empty((S, B, H), dtype=gxp.dtype, device=gxp.device)
    c_seq = torch.empty_like(y) if stash else None
    hn = torch.empty((B, H), dtype=gxp.dtype, device=gxp.device)
    cn = torch.empty_like(hn)
    outs = (y, c_seq, hn, cn, S, B, H, int(bool(norm)))
    if rows is None:
        _launch(lstm_layer_fused, dt, _entry(lib, "lstm_layer_fwd", dt),
                gxp.device, *args, *outs)
    else:
        _launch(lstm_layer_fused, dt, lib.lstm_layer_fwd_at_rows, gxp.device,
                item, rows, *args, *outs)
    return y, c_seq, hn, cn


def layer_launch_shape(B: int, H: int, item: int, rows=None) -> dict:
    """The forward kernel's launch at batch B and hidden size H with
    `item`-byte streams (4: float32, 2: bf16), as the library reckons it:
    the route ("cluster" for H % 4 == 0, else "rows8", one CTA per 8 rows),
    CTAs per cluster (1 on the 8-row route), batch rows per group (`rows`
    overrides the cluster route's choice), groups, the grid in CTAs, the
    dynamic shared memory of one CTA, and how many clusters the card holds
    at once (cudaOccupancyMaxActiveClusters; None on the 8-row route)."""
    lib = _build.library().cdll
    cluster = lib.lstm_layer_fwd_cluster_size(H)
    if rows is None or not cluster:
        rows = lib.lstm_layer_fwd_rows_per_group(B, H, item)
    groups = (B + rows - 1) // rows
    return {"route": "cluster" if cluster else "rows8",
            "cluster": max(cluster, 1), "rows_per_group": rows,
            "groups": groups, "grid": groups * max(cluster, 1),
            "smem_bytes": lib.lstm_layer_fwd_smem_bytes(H, item, rows),
            "max_active_clusters":
                lib.lstm_layer_fwd_max_active_clusters(B, H, item, rows)
                if cluster else None}


# --------------------------------------------------------------- backward --

def lstm_layer_bwd_v2_plain(gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln,
                            bias, h0, c0, dhn, dcn, norm: bool = True):
    """The V2 backward kernel's function, written out in plain PyTorch (the
    hand-derived formulas, no autograd): the reverse loop recomputes
    gh_pre = h_{t-1} @ Wh, both LayerNorms, the gates and c_t from the
    stashed y and c_seq, runs the cell, LN_x and LN_h backward and carries
    dh = d(gh_pre) @ Wh^T, dc = dc * f.

    Returns (dgxp (S, B, 4H), dg_pre (S, B, 4H), dgamma_h (4H,),
    dgamma_x (4H,), sum of dgate (4H,), dh0 (B, H), dc0 (B, H)), as
    lstm_cell.py:_bwd_impl_v2 (whose sums are (1, 4H)): the sums float32,
    the rest in gxp's dtype."""
    S, B, G = gxp.shape
    H = G // 4
    dt = gxp.dtype
    wh = wh.float()
    glnx, blnx, gln, bln, bias = (v.float()
                                  for v in (glnx, blnx, gln, bln, bias))
    dgxp, dg_pre_seq = torch.empty_like(gxp), torch.empty_like(gxp)
    dgln, dglnx, dsum = (torch.zeros(G, device=gxp.device) for _ in range(3))
    dh, dc = dhn.float(), dcn.float()
    for t in range(S - 1, -1, -1):
        h_prev = (y[t - 1] if t else h0).float()
        c_prev = (c_seq[t - 1] if t else c0).float()
        gh_pre = h_prev @ wh
        x = gxp[t].float()
        if norm:
            mean, rstd = _ln_stats(gh_pre)
            xhat = (gh_pre - mean) * rstd
            meanx, rstdx = _ln_stats(x)
            xhatx = (x - meanx) * rstdx
            gate = (xhatx * glnx + blnx + bias) + (xhat * gln + bln)
        else:
            gate = (x + bias) + gh_pre
        si, sf, so, su = _gates(gate, H)
        tc = torch.tanh(sf * c_prev + si * su)
        dh = dh + dy[t].float()
        dc = dc + dh * so * (1.0 - tc * tc)
        dgate = torch.cat([(dc * su) * si * (1.0 - si),
                           (dc * c_prev) * sf * (1.0 - sf),
                           (dh * tc) * so * (1.0 - so),
                           (dc * si) * (1.0 - su * su)], dim=-1)
        if norm:
            dgxp[t] = _ln_bwd(dgate, glnx, xhatx, rstdx)
            dglnx += (dgate * xhatx).sum(0)
            dg_pre = _ln_bwd(dgate, gln, xhat, rstd)
            dgln += (dgate * xhat).sum(0)
        else:
            dgxp[t] = dgate
            dg_pre = dgate
        dsum += dgate.sum(0)
        dg_pre = dg_pre.to(dt).float()     # the stored value carries dh
        dg_pre_seq[t] = dg_pre
        dh = dg_pre @ wh.t()
        dc = dc * sf
    return dgxp, dg_pre_seq, dgln, dglnx, dsum, dh.to(dt), dc.to(dt)


def lstm_layer_bwd_v1_plain(gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln,
                            dhn, dcn, norm: bool = True):
    """The V1 backward kernel's function, written out in plain PyTorch: the
    reverse loop over the precomputed x-side gate gx = LN_x(gxp) + bias and
    gh_pre = h_{t-1} @ Wh, with c_{t-1} and c_t from the stash.

    Returns (dgate (S, B, 4H), dg_pre (S, B, 4H), dh0 (B, H), dc0 (B, H)),
    as lstm_cell.py:_bwd_impl, in gx's dtype; gh_pre is float32 for either
    stream type."""
    S, B, G = gx.shape
    H = G // 4
    dt = gx.dtype
    wh, gln, bln = wh.float(), gln.float(), bln.float()
    dgate_seq, dg_pre_seq = torch.empty_like(gx), torch.empty_like(gx)
    dh, dc = dhn.float(), dcn.float()
    for t in range(S - 1, -1, -1):
        ghp = gh_pre[t].float()
        if norm:
            mean, rstd = _ln_stats(ghp)
            xhat = (ghp - mean) * rstd
            gh = xhat * gln + bln
        else:
            gh = ghp
        si, sf, so, su = _gates(gx[t].float() + gh, H)
        cp = c_prev[t].float()
        tc = torch.tanh(c_seq[t].float())
        dh = dh + dy[t].float()
        dc = dc + dh * so * (1.0 - tc * tc)
        dgate = torch.cat([(dc * su) * si * (1.0 - si),
                           (dc * cp) * sf * (1.0 - sf),
                           (dh * tc) * so * (1.0 - so),
                           (dc * si) * (1.0 - su * su)], dim=-1)
        dg_pre = _ln_bwd(dgate, gln, xhat, rstd) if norm else dgate
        dg_pre = dg_pre.to(dt).float()     # the stored value carries dh
        dgate_seq[t] = dgate
        dg_pre_seq[t] = dg_pre
        dh = dg_pre @ wh.t()
        dc = dc * sf
    return dgate_seq, dg_pre_seq, dh.to(dt), dc.to(dt)


def lstm_layer_bwd_v1_streams(gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0,
                              norm: bool = True):
    """The V1 kernel's precomputed streams, made as lstm_cell.py:_layer_bwd
    makes them (:658-678): the x-side gate gx = LN_x(gxp) + bias from f32
    math, in the stream dtype; gh_pre = h_{t-1} @ Wh (one sequence-wide
    product) in float32 for either stream type; and c_{t-1}, from the
    forward's inputs and stash.  Plain tensor code on either device."""
    x, bias = gxp.float(), bias.float()
    gx = _ln(x, glnx.float(), blnx.float()) + bias if norm else x + bias
    h_prev = torch.cat([h0[None], y[:-1]])
    c_prev = torch.cat([c0[None], c_seq[:-1]])
    return (gx.to(gxp.dtype), torch.matmul(h_prev.float(), wh.float()),
            c_prev)


def lstm_layer_bwd_v2(gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0,
                      c0, dhn, dcn, norm: bool = True):
    """The V2 backward (see lstm_layer_bwd_v2_plain for the function and
    its outputs).  CPU tensors run the plain version; CUDA tensors launch
    the kernel (float32 or bf16, all of one type, contiguous, H % 4 == 0)
    or raise.  The kernel runs one cluster of CTAs per group of rows
    (`v2_launch_shape`); its per-group float32 parameter sums are reduced
    with torch.sum in a fixed order."""
    names = ("gxp", "y", "c_seq", "dy", "wh", "glnx", "blnx", "gln", "bln",
             "bias", "h0", "c0", "dhn", "dcn")
    args = (gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn,
            dcn)
    if _build.on_cpu(*args):
        return lstm_layer_bwd_v2_plain(*args, norm=norm)
    name = "lstm_layer_bwd_v2"
    dt = _stream_dtype(name, gxp)
    _build.check_kernel_inputs(name, dict(zip(names, args)),
                               aligned=("gxp", "wh"),
                               dtypes=dict.fromkeys(names, dt))
    S, B, H = _layer_dims(name, gxp, wh)
    G = 4 * H
    _expect_shapes(name, {
        **{n: (t, (S, B, H)) for n, t in zip(names[1:4], args[1:4])},
        **{n: (t, (G,)) for n, t in zip(names[5:10], args[5:10])},
        **{n: (t, (B, H)) for n, t in zip(names[10:], args[10:])}})
    if H % 4:
        raise ValueError(f"{name}: H must be a multiple of 4; got {H}")
    lib = _build.library().cdll
    _check_smem(name, lib.lstm_layer_bwd_v2_smem_bytes(H, gxp.element_size()),
                H, gxp.device)

    groups = v2_launch_shape(B, H, gxp.element_size())["groups"]
    dgxp, dg_pre = torch.empty_like(gxp), torch.empty_like(gxp)
    part = torch.empty((groups, 3, G), dtype=torch.float32, device=gxp.device)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(h0)
    _launch(lstm_layer_bwd_v2, dt, _entry(lib, "lstm_layer_bwd_v2", dt),
            gxp.device, gxp, y, c_seq, dy, wh, wh.t().contiguous(), glnx,
            blnx, gln, bln, bias, h0, c0, dhn, dcn, dgxp, dg_pre, part, dh0,
            dc0, S, B, H, int(bool(norm)))
    dgln, dglnx, dsum = part.sum(dim=0)
    return dgxp, dg_pre, dgln, dglnx, dsum, dh0, dc0


def v2_launch_shape(B: int, H: int, item: int) -> dict:
    """The V2 kernel's launch at batch B and hidden size H with `item`-byte
    streams (4: float32, 2: bf16), as the library reckons it: batch rows
    per group, CTAs per cluster (one cluster per group; each CTA owns
    H / cluster units), groups, and the grid in CTAs."""
    lib = _build.library().cdll
    rows = lib.lstm_layer_bwd_v2_rows_per_group(H, item)
    cluster = lib.lstm_layer_bwd_v2_cluster_size(H)
    groups = (B + rows - 1) // rows
    return {"rows_per_group": rows, "cluster": cluster, "groups": groups,
            "grid": groups * cluster}


lstm_layer_bwd_v2.launches = 0
lstm_layer_bwd_v2.launches_bf16 = 0


def lstm_layer_bwd_v1(gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn,
                      norm: bool = True):
    """The V1 backward (see lstm_layer_bwd_v1_plain for the function and
    its outputs).  CPU tensors run the plain version; CUDA tensors launch
    the kernel (float32 or bf16 streams, all of gx's type but gh_pre, which
    is float32; contiguous, H % 4 == 0) or raise.  The kernel runs one
    cluster of CTAs per group of rows (`v1_launch_shape`)."""
    args = (gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn)
    if _build.on_cpu(*args):
        return lstm_layer_bwd_v1_plain(*args, norm=norm)
    return _lstm_layer_bwd_v1_cuda(*args, norm=norm)


def _lstm_layer_bwd_v1_cuda(gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn,
                            dcn, norm, cluster=None, rows=None):
    """The V1 kernel's launch.  `cluster` and `rows` override the route's
    choices, to measure the candidates; by default the library chooses
    (`v1_launch_shape`)."""
    name = "lstm_layer_bwd_v1"
    names = ("gx", "gh_pre", "c_prev", "c_seq", "dy", "wh", "gln", "bln",
             "dhn", "dcn")
    args = (gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn)
    dt = _stream_dtype(name, gx)
    _build.check_kernel_inputs(name, dict(zip(names, args)),
                               aligned=("gh_pre",),
                               dtypes={**dict.fromkeys(names, dt),
                                       "gh_pre": torch.float32})
    S, B, H = _layer_dims(name, gx, wh)
    G = 4 * H
    _expect_shapes(name, {
        "gh_pre": (gh_pre, (S, B, G)),
        **{n: (t, (S, B, H)) for n, t in zip(names[2:5], args[2:5])},
        "gln": (gln, (G,)), "bln": (bln, (G,)),
        "dhn": (dhn, (B, H)), "dcn": (dcn, (B, H))})
    shape = v1_launch_shape(B, H, gx.element_size(), cluster, rows)
    _check_smem(name, shape["smem_bytes"], H, gx.device)

    lib = _build.library().cdll
    dgate, dg_pre = torch.empty_like(gx), torch.empty_like(gx)
    dh0, dc0 = torch.empty_like(dhn), torch.empty_like(dhn)
    _launch(lstm_layer_bwd_v1, dt, _entry(lib, "lstm_layer_bwd_v1", dt),
            gx.device, *args, dgate, dg_pre, dh0, dc0, S, B, H,
            int(bool(norm)), shape["cluster"], shape["rows_per_group"])
    return dgate, dg_pre, dh0, dc0


def v1_launch_shape(B: int, H: int, item: int, cluster=None,
                    rows=None) -> dict:
    """The V1 kernel's launch at batch B and hidden size H (H % 4 == 0)
    with `item`-byte streams (4: float32, 2: bf16), as the library reckons
    it: the route ("cluster": one thread-block cluster per group of rows),
    CTAs per cluster (16 where H % 64 == 0, else 4-8 dividing H; each CTA
    owns H / cluster units), batch rows per group (8, or 16 where 8-row
    groups would not fit in one wave), groups, the grid in CTAs and the
    dynamic shared memory of one CTA.  `cluster` and `rows` override the
    route's choices."""
    if H % 4:
        raise ValueError(f"lstm_layer_bwd_v1: H must be a multiple of 4; "
                         f"got {H}")
    lib = _build.library().cdll
    cluster = cluster or lib.lstm_layer_bwd_v1_cluster_size(H)
    if H % cluster:
        raise ValueError(f"lstm_layer_bwd_v1: a cluster of {cluster} CTAs "
                         f"does not divide H={H}")
    rows = rows or lib.lstm_layer_bwd_v1_rows_per_group(B, H, item, cluster)
    groups = (B + rows - 1) // rows
    return {"route": "cluster", "cluster": cluster, "rows_per_group": rows,
            "groups": groups, "grid": groups * cluster,
            "smem_bytes": lib.lstm_layer_bwd_v1_smem_bytes(H, item, cluster,
                                                           rows)}


lstm_layer_bwd_v1.launches = 0
lstm_layer_bwd_v1.launches_bf16 = 0


def _layer_backward(saved, dy, dhn, dcn, norm):
    """lstm_cell.py:_layer_bwd: the 9 gradients (dgxp, dwh, dglnx, dblnx,
    dgln, dbln, dbias, dh0, dc0) from the forward's inputs and stash, each
    in its input's dtype (the parameter sums are float32 and are cast at
    the end, as at lstm_cell.py:644-656 and :683-699)."""
    gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y, c_seq = saved
    B, H = h0.shape
    G = 4 * H
    if B >= V2_MIN_BATCH:
        # The kernel's dgamma sums are zero without the LayerNorms.
        dgxp, dg_pre, dgln, dglnx, dsum, dh0, dc0 = lstm_layer_bwd_v2(
            gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn,
            dcn, norm)
        # dWh from the unshifted stash: h_{t-1} is h0 at t = 0, y[t-1] after.
        with span("dihpc.gemm.lstm_dwh"):
            dwh = h0.t() @ dg_pre[0] + (y[:-1].reshape(-1, H).t()
                                        @ dg_pre[1:].reshape(-1, G))
    else:
        # V1: the x-side gate and gh_pre as sequence-wide tensor code first,
        # the LN_x backward and the parameter sums after, in float32.
        gx, gh_pre, c_prev = lstm_layer_bwd_v1_streams(
            gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0, norm)
        dgate, dg_pre, dh0, dc0 = lstm_layer_bwd_v1(
            gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn, norm)
        h_prev = torch.cat([h0[None], y[:-1]])
        with span("dihpc.gemm.lstm_dwh"):
            dwh = h_prev.reshape(-1, H).t() @ dg_pre.reshape(-1, G)
        dgate32 = dgate.float()
        dsum = dgate32.sum(dim=(0, 1))
        dgxp = dgate                    # without LN_x, gx = gxp + bias
        if norm:
            mean, rstd = _ln_stats(gh_pre)
            dgln = (dgate32 * ((gh_pre - mean) * rstd)).sum(dim=(0, 1))
            x = gxp.float()
            meanx, rstdx = _ln_stats(x)
            xhatx = (x - meanx) * rstdx
            dgxp = _ln_bwd(dgate32, glnx.float(), xhatx, rstdx).to(gxp.dtype)
            dglnx = (dgate32 * xhatx).sum(dim=(0, 1))
    if not norm:
        return (dgxp, dwh, torch.zeros_like(glnx), torch.zeros_like(blnx),
                torch.zeros_like(gln), torch.zeros_like(bln),
                dsum.to(bias.dtype), dh0, dc0)
    # The sum of dgate is dbeta_x, dbeta_h and dbias alike; each gradient
    # gets a tensor of its own.
    return (dgxp, dwh, dglnx.to(glnx.dtype), dsum.to(blnx.dtype, copy=True),
            dgln.to(gln.dtype), dsum.to(bln.dtype, copy=True),
            dsum.to(bias.dtype, copy=True), dh0, dc0)


class _LayerFunction(torch.autograd.Function):
    """lstm_layer_fused with its hand-derived backward: the counterpart of
    the custom VJP at lstm_cell.py:246-709.  The forward stashes the cell
    states; the backward returns the 9 gradients in argument order, inside
    the span `dihpc.lstm.layer.kernel.bwd` (the backward of a layer on
    network.lstm_fused's kernel route)."""

    @staticmethod
    def forward(ctx, gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, norm):
        y, c_seq, hn, cn = lstm_layer_stash(gxp, wh, glnx, blnx, gln, bln,
                                            bias, h0, c0, norm)
        ctx.norm = norm
        ctx.save_for_backward(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, y,
                              c_seq)
        return y, hn, cn

    @staticmethod
    def backward(ctx, dy, dhn, dcn):
        with span("dihpc.lstm.layer.kernel.bwd"):
            grads = _layer_backward(ctx.saved_tensors, dy.contiguous(),
                                    dhn.contiguous(), dcn.contiguous(),
                                    ctx.norm)
        return (*grads, None)
