"""RL recurrence kernels: the hand-written Hopper kernels (csrc/vtrace.cu,
csrc/rl_scans.cu) and their plain PyTorch versions.

Counterparts of the V-trace part of di_hpc_tpu/pallas_kernels/rl_scans.py:

  - `vtrace_losses` ~ `vtrace_losses_pallas` / `_vtrace_losses_impl`: the
    clipped recurrence, the advantage and both loss sums in one pass; the
    (T, B) returns/advantage planes never reach device memory.  Returns
    (pg_loss, value_loss) = (-sum(logp*adv)/TB, sum((V - vs)^2)/TB).
  - `vtrace_returns_adv` ~ `vtrace_returns_adv_pallas`: the same recurrence,
    writing the vs and advantage planes (the weighted path of
    ops.vtrace_error).

Both kernels chunk the reverse recurrence over T (csrc/vtrace.cu); their
launch shape is `vtrace_launch_shape(T, B)`.

Both wrappers are torch.autograd.Functions on either device, with the
JAX package's gradients.  `vtrace_losses` follows the V-trace stop-gradient
contract (rl_scans.py:644-663): its backward recomputes vs and the
advantage with `vtrace_returns_adv` and gives d pg/d lp = -ct*adv/TB,
d vl/d value[:-1] = 2*ct*(value - vs)/TB, and zeros to the importance
weights, the rewards and value[T].  `vtrace_returns_adv` has the zero
gradient of rl_scans.py:507-511.

And of its row-constant-coefficient part (csrc/rl_scans.cu: GAE and the
TD(lambda) returns, loss and error chunked over T like V-trace, their
launches `gae_launch_shape(T, B)`, `lambda_returns_launch_shape(T, B)`,
`td_lambda_launch_shape(T, B)` and `td_lambda_err_launch_shape(T, B)`):

  - `gae` ~ `gae_fused_pallas`: value (T+1, B), reward (T, B) -> advantage
    (T, B), dividing by `ops.scan.gae_denominators` as the JAX wrapper does.
  - `lambda_returns` ~ `lambda_returns_pallas`: the lambda-returns (T, B)
    for scalar gamma and lambda.
  - `td_lambda_loss` ~ `td_lambda_loss_pallas`: 0.5 * sum((ret - V[:-1])^2)
    / TB from per-column partial sums, with the recompute backward of
    rl_scans.py:317-323: `td_lambda_err` gives e = ret - V[:-1], then
    d value[:-1] = -ct*e/TB, and value[T] and the rewards get zeros.
  - `td_lambda_err` ~ `_tdl_err_impl`: e (T, B), a detached tensor.

`gae` and `lambda_returns` have the zero gradient of rl_scans.py:113-116 and
:179-182.

And of its UPGO part (a full plane of binary lambdas derived in-kernel,
csrc/rl_scans.cu, both kernels one walk chunked over T with two
epilogues):

  - `upgo_advantages` ~ `upgo_advantages_pallas`: rhos * (upgo_returns -
    V[:-1]) (T, B), chunked over T (`upgo_advantages_launch_shape(T, B)`),
    with the zero gradient of rl_scans.py:360-363.
  - `upgo_loss` ~ `upgo_loss_pallas`: -sum(adv * lp) / TB from per-column
    partial sums, chunked over T (`upgo_loss_launch_shape(T, B)`), with the
    recompute backward of rl_scans.py:452-465:
    `upgo_advantages` gives adv, d lp = -ct*adv/TB, and rhos, reward and
    value get zeros.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["vtrace_losses", "vtrace_losses_plain", "vtrace_returns_adv",
           "vtrace_returns_adv_plain", "vtrace_launch_shape",
           "td_lambda_launch_shape", "td_lambda_err_launch_shape",
           "lambda_returns_launch_shape", "upgo_loss_launch_shape",
           "upgo_advantages_launch_shape",
           "gae_launch_shape", "chunked_launch_shape", "gae",
           "gae_plain", "lambda_returns", "lambda_returns_plain",
           "td_lambda_loss", "td_lambda_loss_plain", "td_lambda_err",
           "td_lambda_err_plain", "upgo_advantages", "upgo_advantages_plain",
           "upgo_loss", "upgo_loss_plain"]


def vtrace_returns_adv_plain(is_weights, reward, value, gamma=0.99,
                             lambda_=0.95, rho_clip=1.0, c_clip=1.0,
                             pg_clip=1.0):
    """The kernels' reverse loop in plain PyTorch: (vs, adv), each (T, B),
    computed from detached inputs."""
    is_weights, reward, value = (x.detach() for x in
                                 (is_weights, reward, value))
    T = reward.shape[0]
    gl = gamma * lambda_
    v_next = value[T]
    vs_next = v_next
    item = torch.zeros_like(v_next)
    ret, adv = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        rho = torch.clamp(is_weights[t], max=rho_clip)
        c = torch.clamp(is_weights[t], max=c_clip)
        pg = torch.clamp(is_weights[t], max=pg_clip)
        delta = rho * (reward[t] + gamma * v_next - value[t])
        item = delta + (gl * c) * item
        ret[t] = value[t] + item
        adv[t] = pg * (reward[t] + gamma * vs_next - value[t])
        v_next, vs_next = value[t], ret[t]
    return torch.stack(ret), torch.stack(adv)


def vtrace_losses_plain(is_weights, lp, reward, value, gamma=0.99,
                        lambda_=0.95, rho_clip=1.0, c_clip=1.0, pg_clip=1.0):
    """(pg_loss, value_loss) in plain PyTorch; differentiable in lp and
    value[:-1] only."""
    T, B = reward.shape
    ret, adv = vtrace_returns_adv_plain(is_weights, reward, value, gamma,
                                        lambda_, rho_clip, c_clip, pg_clip)
    pg_loss = -torch.sum(lp * adv) / (T * B)
    value_loss = torch.sum((value[:-1] - ret) ** 2) / (T * B)
    return pg_loss, value_loss


def _check(name, tensors: dict, T, B) -> dict:
    """A CUDA kernel's inputs, made contiguous and checked; raises on what
    the kernel cannot take.  A strided view (a (T, B) slice of a wider
    buffer) is copied here: the kernels read dense planes, and the copy is
    part of the call's time."""
    tensors = {arg: t.contiguous() for arg, t in tensors.items()}
    _build.check_kernel_inputs(name, tensors)
    for arg, t in tensors.items():
        want = (T + 1, B) if arg == "value" else (T, B)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} must be {want}; got "
                             f"{tuple(t.shape)}")
    if T < 1 or B < 1:
        raise ValueError(f"{name}: T and B must be >= 1; got T={T}, B={B}")
    return tensors


def _scalars(gamma, lambda_, rho_clip, c_clip, pg_clip):
    return (float(gamma), float(gamma * lambda_), float(rho_clip),
            float(c_clip), float(pg_clip))


# Steps of one thread in a super-tile (kChunk in csrc/vtrace.cu and
# csrc/chunked_scan.cuh), the most chunks in a super-tile and the most
# threads in a CTA (kMaxThreads).
SCAN_CHUNK = 8
SCAN_MAX_CHUNKS = 16
SCAN_MAX_THREADS = 512


def chunked_launch_shape(name: str, T: int, B: int, sms: int, cols,
                         chunks, smem_floats: int) -> dict:
    """The launch of a kernel chunked over T (csrc/vtrace.cu,
    csrc/chunked_scan.cuh) at (T, B) on a card with `sms` SMs: a CTA owns
    `cols` neighbouring columns (32, or 16 or 8 where wider tiles would give
    fewer than sms / 2 CTAs) and `chunks` chunks of SCAN_CHUNK steps each
    (up to 16), one thread per column and chunk; together the chunks make a
    super-tile, and the CTA walks ceil(T / super_tile_steps) of them.  The
    grid is ceil(B / cols) CTAs.  `cols` and `chunks` override the choice.
    The dynamic shared memory holds `smem_floats` floats per thread."""
    if T < 1 or B < 1:
        raise ValueError(f"{name}: T and B must be >= 1; got T={T}, B={B}")
    if cols is None:
        cols = 32
        while cols > 8 and -(-B // cols) < sms // 2:
            cols //= 2
    chunks = chunks or min(-(-T // SCAN_CHUNK), SCAN_MAX_CHUNKS)
    if cols * chunks > SCAN_MAX_THREADS:
        raise ValueError(f"{name}: {cols} columns x {chunks} chunks exceed "
                         f"{SCAN_MAX_THREADS} threads")
    steps, threads = chunks * SCAN_CHUNK, cols * chunks
    return {"cols": cols, "chunk": SCAN_CHUNK, "chunks": chunks,
            "threads": threads, "super_tile_steps": steps,
            "super_tiles": -(-T // steps), "grid": -(-B // cols),
            "smem_bytes": smem_floats * threads * 4}


def vtrace_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                        chunks=None) -> dict:
    """The V-trace kernels' launch (chunked_launch_shape); the CTA walks
    its super-tiles from the last.  The dynamic shared memory holds two
    buffers of the chunks' (A, D) pairs and the losses' chunk partials."""
    return chunked_launch_shape("vtrace", T, B, sms, cols, chunks, 6)


def td_lambda_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                           chunks=None) -> dict:
    """The TD(lambda) loss kernel's launch (chunked_launch_shape); the CTA
    walks its super-tiles from the last.  The dynamic shared memory holds
    two buffers of the chunks' (A, D) pairs and the chunk partials."""
    return chunked_launch_shape("td_lambda_loss", T, B, sms, cols, chunks, 5)


def td_lambda_err_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                               chunks=None) -> dict:
    """The TD(lambda) error kernel's launch (chunked_launch_shape): the loss
    kernel's walk with another epilogue, whose shared memory holds only the
    two buffers of the chunks' (A, D) pairs."""
    return chunked_launch_shape("td_lambda_err", T, B, sms, cols, chunks, 4)


def lambda_returns_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                                chunks=None) -> dict:
    """The lambda-returns kernel's launch (chunked_launch_shape): the
    error kernel's walk storing the returns, with the same two buffers of
    the chunks' (A, D) pairs in shared memory."""
    return chunked_launch_shape("lambda_returns", T, B, sms, cols, chunks, 4)


def upgo_loss_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                           chunks=None) -> dict:
    """The UPGO loss kernel's launch (chunked_launch_shape); the CTA walks
    its super-tiles from the last.  The dynamic shared memory holds two
    buffers of the chunks' (A, D) pairs and the chunk partials."""
    return chunked_launch_shape("upgo_loss", T, B, sms, cols, chunks, 5)


def upgo_advantages_launch_shape(T: int, B: int, sms: int = 132,
                                 cols=None, chunks=None) -> dict:
    """The UPGO advantage kernel's launch (chunked_launch_shape): the loss
    kernel's walk storing the advantage plane, whose shared memory holds
    only the two buffers of the chunks' (A, D) pairs."""
    return chunked_launch_shape("upgo_advantages", T, B, sms, cols, chunks,
                                4)


def gae_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                     chunks=None) -> dict:
    """The GAE kernel's launch (chunked_launch_shape); the CTA walks its
    super-tiles from the last.  The dynamic shared memory holds two buffers
    of the chunks' (A, D) pairs."""
    return chunked_launch_shape("gae", T, B, sms, cols, chunks, 4)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_vtrace(name, entry, tensors, T, B, clips, cols, chunks):
    """One V-trace kernel launch on the current stream of the tensors'
    device: `tensors` are the entry point's inputs and outputs in its
    argument order."""
    device = tensors[0].device
    shape = vtrace_launch_shape(T, B, _sms(device), cols, chunks)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(*(t.data_ptr() for t in tensors), T, B,
                       *_scalars(*clips), shape["cols"], shape["chunks"],
                       stream)
    _build.check_status(name, status)


def vtrace_losses(is_weights, lp, reward, value, gamma: float = 0.99,
                  lambda_: float = 0.95, rho_clip: float = 1.0,
                  c_clip: float = 1.0, pg_clip: float = 1.0):
    """Unit-weight V-trace losses (pg_loss, value_loss), recurrence, clips,
    advantage and both sums in one kernel pass.  IS, lp, reward (T, B) and
    value (T+1, B).  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise.  Differentiable in lp and value[:-1]."""
    return _VtraceLossesFunction.apply(is_weights, lp, reward, value, gamma,
                                       lambda_, rho_clip, c_clip, pg_clip)


vtrace_losses.launches = 0


def _vtrace_losses_forward(is_weights, lp, reward, value, *clips):
    if _build.on_cpu(is_weights, lp, reward, value):
        return vtrace_losses_plain(is_weights, lp, reward, value, *clips)
    return _vtrace_losses_cuda(is_weights, lp, reward, value, *clips)


def _vtrace_losses_cuda(is_weights, lp, reward, value, *clips, cols=None,
                        chunks=None):
    """The losses kernel's launch; `cols` and `chunks` override
    vtrace_launch_shape's choice, to measure the candidates."""
    name = "vtrace_losses"
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    is_weights, lp, reward, value = _check(
        name, {"is_weights": is_weights, "lp": lp, "reward": reward,
               "value": value}, T, B).values()
    parts = torch.empty((2, B), dtype=torch.float32, device=reward.device)
    _launch_vtrace(name, _build.library().cdll.vtrace_losses_f32,
                   (is_weights, lp, reward, value, parts), T, B, clips, cols,
                   chunks)
    vtrace_losses.launches += 1
    # torch.sum on the card reduces in a fixed order: no float atomics, so
    # repeated runs are bitwise equal (docs/DESIGN.md section 3).
    sums = parts.sum(dim=1)
    return -sums[0] / (T * B), sums[1] / (T * B)


class _VtraceLossesFunction(torch.autograd.Function):
    """vtrace_losses with the recompute backward of rl_scans.py:651-660."""

    @staticmethod
    def forward(ctx, is_weights, lp, reward, value, *clips):
        ctx.clips = clips
        ctx.save_for_backward(is_weights, reward, value)
        return _vtrace_losses_forward(is_weights, lp, reward, value, *clips)

    @staticmethod
    def backward(ctx, ct_pg, ct_vl):
        is_weights, reward, value = ctx.saved_tensors
        T, B = reward.shape
        ret, adv = vtrace_returns_adv(is_weights, reward, value, *ctx.clips)
        dlp = (-ct_pg / (T * B)) * adv
        dvalue = torch.zeros_like(value)
        dvalue[:-1] = (ct_vl * 2.0 / (T * B)) * (value[:-1] - ret)
        d_is, d_reward = (torch.zeros_like(t) if ctx.needs_input_grad[i]
                          else None for t, i in ((is_weights, 0), (reward, 2)))
        return (d_is, dlp, d_reward, dvalue, *(None,) * len(ctx.clips))


def vtrace_returns_adv(is_weights, reward, value, gamma: float = 0.99,
                       lambda_: float = 0.95, rho_clip: float = 1.0,
                       c_clip: float = 1.0, pg_clip: float = 1.0):
    """V-trace (vs, advantages), each (T, B), the three min(IS, clip)
    planes derived in-kernel.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.  Its gradient is zero."""
    return _ZeroGradFunction.apply(_vtrace_returns_adv_forward, is_weights,
                                   reward, value, gamma, lambda_, rho_clip,
                                   c_clip, pg_clip)


vtrace_returns_adv.launches = 0


def _vtrace_returns_adv_forward(is_weights, reward, value, *clips):
    if _build.on_cpu(is_weights, reward, value):
        return vtrace_returns_adv_plain(is_weights, reward, value, *clips)
    return _vtrace_returns_adv_cuda(is_weights, reward, value, *clips)


def _vtrace_returns_adv_cuda(is_weights, reward, value, *clips, cols=None,
                             chunks=None):
    """The returns/advantage kernel's launch; `cols` and `chunks` as in
    _vtrace_losses_cuda."""
    name = "vtrace_returns_adv"
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    is_weights, reward, value = _check(
        name, {"is_weights": is_weights, "reward": reward, "value": value},
        T, B).values()
    ret = torch.empty((T, B), dtype=torch.float32, device=reward.device)
    adv = torch.empty_like(ret)
    _launch_vtrace(name, _build.library().cdll.vtrace_returns_adv_f32,
                   (is_weights, reward, value, ret, adv), T, B, clips, cols,
                   chunks)
    vtrace_returns_adv.launches += 1
    return ret, adv


class _ZeroGradFunction(torch.autograd.Function):
    """forward(*args) for a recurrence target: every tensor argument gets a
    zero gradient (rl_scans.py:113-116, :179-182, :507-511)."""

    @staticmethod
    def forward(ctx, forward, *args):
        ctx.specs = [(a.shape, a.dtype, a.device)
                     if isinstance(a, torch.Tensor) else None for a in args]
        return forward(*args)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(torch.zeros(spec[0], dtype=spec[1], device=spec[2])
                        if spec is not None and needed else None
                        for spec, needed in zip(ctx.specs,
                                                ctx.needs_input_grad[1:])))


# ---------------------------------------------------------------------------
# Row-constant-coefficient recurrences: GAE, lambda-returns, TD(lambda)
# ---------------------------------------------------------------------------

def _gae_denominators(T, lambda_, like):
    from ..ops.scan import gae_denominators   # ops imports this module
    return gae_denominators(T, lambda_, dtype=like.dtype, device=like.device)


def gae_plain(value, reward, gamma=0.99, lambda_=0.97):
    """The GAE kernel's reverse loop in plain PyTorch: adv (T, B) from
    detached inputs, dividing by the same denominators."""
    value, reward = value.detach(), reward.detach()
    T = reward.shape[0]
    denom = _gae_denominators(T, lambda_, reward)
    gl = gamma * lambda_
    y = torch.zeros_like(value[T])
    adv = [None] * T
    for t in range(T - 1, -1, -1):
        delta = reward[t] + gamma * value[t + 1] - value[t]
        y = denom[t] * delta + gl * y
        adv[t] = y / denom[t]
    return torch.stack(adv)


def lambda_returns_plain(value, reward, gamma, lambda_):
    """The lambda-returns kernel's reverse loop in plain PyTorch: ret (T, B)
    from detached inputs.  The last step takes gamma on V_T and no carry
    (_lret_body's b_{T-1} = 0), every earlier step gamma - gamma*lambda on
    V_{t+1} and gamma*lambda on ret_{t+1}."""
    value, reward = value.detach(), reward.detach()
    T = reward.shape[0]
    gl = gamma * lambda_
    ret = torch.zeros_like(value[T])
    g_eff, carry = gamma, 0.0
    out = [None] * T
    for t in range(T - 1, -1, -1):
        ret = reward[t] + g_eff * value[t + 1] + carry * ret
        g_eff, carry = gamma - gl, gl
        out[t] = ret
    return torch.stack(out)


def td_lambda_err_plain(value, reward, gamma, lambda_):
    """e = ret - V[:-1] (T, B) in plain PyTorch, from detached inputs."""
    return (lambda_returns_plain(value, reward, gamma, lambda_)
            - value[:-1].detach())


def td_lambda_loss_plain(value, reward, gamma, lambda_):
    """0.5 * sum((ret - V[:-1])^2) / TB in plain PyTorch, summed per column
    first as the kernel does; differentiable in value[:-1] only."""
    T, B = reward.shape
    e = lambda_returns_plain(value, reward, gamma, lambda_) - value[:-1]
    return 0.5 * (e * e).sum(dim=0).sum() / (T * B)


def _check_pair(name, value, reward):
    """A CUDA kernel's value (T+1, B) and reward (T, B), contiguous; raises
    on what the kernel cannot take."""
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    return _check(name, {"value": value, "reward": reward}, T, B).values()


def _launch(name, fn, tensors, gamma, lambda_, *tiling):
    """Launch entry point `fn` on the current stream of checked tensors (its
    pointer arguments, reward (T, B) second) and raise on a refused launch;
    `tiling` is a chunked kernel's (cols, chunks)."""
    T, B = tensors[1].shape
    with torch.cuda.device(tensors[1].device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(_build.library().cdll, fn)(
            *(t.data_ptr() for t in tensors), T, B, float(gamma),
            float(gamma * lambda_), *tiling, stream)
    _build.check_status(name, status)


def _tiling(shape_fn, reward, cols, chunks):
    """(cols, chunks) of a chunked kernel's launch on reward's card."""
    T, B = reward.shape
    shape = shape_fn(T, B, _sms(reward.device), cols, chunks)
    return shape["cols"], shape["chunks"]


def _gae_forward(value, reward, gamma, lambda_):
    if _build.on_cpu(value, reward):
        return gae_plain(value, reward, gamma, lambda_)
    return _gae_cuda(value, reward, gamma, lambda_)


def _gae_cuda(value, reward, gamma, lambda_, cols=None, chunks=None):
    """The GAE kernel's launch; `cols` and `chunks` override
    gae_launch_shape's choice, to measure the candidates."""
    value, reward = _check_pair("gae", value, reward)
    tiling = _tiling(gae_launch_shape, reward, cols, chunks)
    denom = _gae_denominators(reward.shape[0], lambda_, reward)
    adv = torch.empty_like(reward)
    _launch("gae", "gae_f32", (value, reward, denom, adv), gamma, lambda_,
            *tiling)
    gae.launches += 1
    return adv


def _lambda_returns_forward(value, reward, gamma, lambda_):
    if _build.on_cpu(value, reward):
        return lambda_returns_plain(value, reward, gamma, lambda_)
    return _lambda_returns_cuda(value, reward, gamma, lambda_)


def _lambda_returns_cuda(value, reward, gamma, lambda_, cols=None,
                         chunks=None):
    """The returns kernel's launch; `cols` and `chunks` override
    lambda_returns_launch_shape's choice, to measure the candidates."""
    value, reward = _check_pair("lambda_returns", value, reward)
    tiling = _tiling(lambda_returns_launch_shape, reward, cols, chunks)
    ret = torch.empty_like(reward)
    _launch("lambda_returns", "lambda_returns_f32", (value, reward, ret),
            gamma, lambda_, *tiling)
    lambda_returns.launches += 1
    return ret


def gae(value, reward, gamma: float = 0.99, lambda_: float = 0.97):
    """GAE advantages (T, B) from value (T+1, B) and reward (T, B):
    delta, the recurrence and the divide by the denominators in one pass.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Its gradient is zero."""
    return _ZeroGradFunction.apply(_gae_forward, value, reward, gamma,
                                   lambda_)


gae.launches = 0


def lambda_returns(value, reward, gamma: float, lambda_: float):
    """Generalized lambda-returns (T, B) for scalar gamma and lambda from
    value (T+1, B) and reward (T, B).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise.  Its gradient is zero."""
    return _ZeroGradFunction.apply(_lambda_returns_forward, value, reward,
                                   gamma, lambda_)


lambda_returns.launches = 0


def td_lambda_err(value, reward, gamma: float, lambda_: float):
    """e = lambda-returns - value[:-1], (T, B), detached: the TD(lambda)
    loss's backward.  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if _build.on_cpu(value, reward):
        return td_lambda_err_plain(value, reward, gamma, lambda_)
    return _td_lambda_err_cuda(value, reward, gamma, lambda_)


td_lambda_err.launches = 0


def _td_lambda_err_cuda(value, reward, gamma, lambda_, cols=None,
                        chunks=None):
    """The error kernel's launch; `cols` and `chunks` override
    td_lambda_err_launch_shape's choice, to measure the candidates."""
    value, reward = _check_pair("td_lambda_err", value, reward)
    tiling = _tiling(td_lambda_err_launch_shape, reward, cols, chunks)
    err = torch.empty_like(reward)
    _launch("td_lambda_err", "td_lambda_err_f32", (value, reward, err), gamma,
            lambda_, *tiling)
    td_lambda_err.launches += 1
    return err


def _td_lambda_loss_forward(value, reward, gamma, lambda_):
    if _build.on_cpu(value, reward):
        return td_lambda_loss_plain(value, reward, gamma, lambda_)
    return _td_lambda_loss_cuda(value, reward, gamma, lambda_)


def _td_lambda_loss_cuda(value, reward, gamma, lambda_, cols=None,
                         chunks=None):
    """The loss kernel's launch; `cols` and `chunks` override
    td_lambda_launch_shape's choice, to measure the candidates."""
    value, reward = _check_pair("td_lambda_loss", value, reward)
    tiling = _tiling(td_lambda_launch_shape, reward, cols, chunks)
    parts = torch.empty((1, reward.shape[1]), dtype=torch.float32,
                        device=reward.device)
    _launch("td_lambda_loss", "td_lambda_loss_f32", (value, reward, parts),
            gamma, lambda_, *tiling)
    td_lambda_loss.launches += 1
    # One partial per column, summed by torch.sum in a fixed order: no float
    # atomics, so repeated runs are bitwise equal.
    return 0.5 * parts.sum() / reward.numel()


class _TDLambdaLossFunction(torch.autograd.Function):
    """td_lambda_loss with the recompute backward of rl_scans.py:317-323."""

    @staticmethod
    def forward(ctx, value, reward, gamma, lambda_):
        ctx.scalars = (gamma, lambda_)
        ctx.save_for_backward(value, reward)
        return _td_lambda_loss_forward(value, reward, gamma, lambda_)

    @staticmethod
    def backward(ctx, ct):
        value, reward = ctx.saved_tensors
        e = td_lambda_err(value, reward, *ctx.scalars)
        dvalue = torch.zeros_like(value)
        dvalue[:-1] = (-ct / reward.numel()) * e
        d_reward = torch.zeros_like(reward) if ctx.needs_input_grad[1] \
            else None
        return dvalue, d_reward, None, None


def td_lambda_loss(value, reward, gamma: float, lambda_: float):
    """Unit-weight TD(lambda) loss 0.5 * mean((ret - value[:-1])^2), the
    returns detached, from value (T+1, B) and reward (T, B) in one kernel
    pass.  CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise.  Differentiable in value[:-1]; value[T] and the rewards get
    zeros."""
    return _TDLambdaLossFunction.apply(value, reward, gamma, lambda_)


td_lambda_loss.launches = 0


# ---------------------------------------------------------------------------
# UPGO: binary-lambda returns (full-plane coefficients), advantage, loss
# ---------------------------------------------------------------------------

def upgo_advantages_plain(rhos, reward, value):
    """The UPGO kernels' reverse loop in plain PyTorch: adv = rhos * (ret -
    V[:-1]) (T, B) from detached inputs, with d_t = 1[r_{t+1} + V_{t+2} >=
    V_{t+1}] (rl_scans.py:343-347), d_{T-1} = 0, and ret_t = r_t + (1 -
    d_t) * V_{t+1} + d_t * ret_{t+1}."""
    rhos, reward, value = (x.detach() for x in (rhos, reward, value))
    T = reward.shape[0]
    lam = ((reward + value[1:]) >= value[:-1]).to(reward.dtype)
    d = torch.cat([lam[1:], torch.zeros_like(lam[:1])])
    a = reward + (1.0 - d) * value[1:]
    ret = torch.zeros_like(value[T])
    out = [None] * T
    for t in range(T - 1, -1, -1):
        ret = a[t] + d[t] * ret
        out[t] = ret
    return rhos * (torch.stack(out) - value[:-1])


def upgo_loss_plain(rhos, lp, reward, value):
    """-sum(adv * lp) / TB in plain PyTorch, summed per column first as the
    kernel does; differentiable in lp only."""
    T, B = reward.shape
    adv = upgo_advantages_plain(rhos, reward, value)
    return -(adv * lp).sum(dim=0).sum() / (T * B)


def _check_upgo(name, tensors: dict):
    """A UPGO kernel's (T, B) planes and value (T+1, B), contiguous, and
    (T, B)."""
    reward = tensors["reward"]
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    return _check(name, tensors, T, B).values(), T, B


def _upgo_advantages_forward(rhos, reward, value):
    if _build.on_cpu(rhos, reward, value):
        return upgo_advantages_plain(rhos, reward, value)
    return _upgo_advantages_cuda(rhos, reward, value)


def _upgo_advantages_cuda(rhos, reward, value, cols=None, chunks=None):
    """The UPGO advantage kernel's launch; `cols` and `chunks` override
    upgo_advantages_launch_shape's choice, to measure the candidates."""
    name = "upgo_advantages"
    (rhos, reward, value), T, B = _check_upgo(
        name, {"rhos": rhos, "reward": reward, "value": value})
    tiling = _tiling(upgo_advantages_launch_shape, reward, cols, chunks)
    adv = torch.empty_like(reward)
    with torch.cuda.device(reward.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.library().cdll.upgo_advantages_f32(
            rhos.data_ptr(), reward.data_ptr(), value.data_ptr(),
            adv.data_ptr(), T, B, *tiling, stream)
    _build.check_status(name, status)
    upgo_advantages.launches += 1
    return adv


def upgo_advantages(rhos, reward, value):
    """UPGO advantages rhos * (upgo_returns - value[:-1]) (T, B) from rhos,
    reward (T, B) and value (T+1, B) in one pass.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.  Its gradient is zero
    (rl_scans.py:360-363)."""
    return _ZeroGradFunction.apply(_upgo_advantages_forward, rhos, reward,
                                   value)


upgo_advantages.launches = 0


def _upgo_loss_forward(rhos, lp, reward, value):
    if _build.on_cpu(rhos, lp, reward, value):
        return upgo_loss_plain(rhos, lp, reward, value)
    return _upgo_loss_cuda(rhos, lp, reward, value)


def _upgo_loss_cuda(rhos, lp, reward, value, cols=None, chunks=None):
    """The UPGO loss kernel's launch; `cols` and `chunks` override
    upgo_loss_launch_shape's choice, to measure the candidates."""
    (rhos, lp, reward, value), T, B = _check_upgo(
        "upgo_loss", {"rhos": rhos, "lp": lp, "reward": reward,
                      "value": value})
    tiling = _tiling(upgo_loss_launch_shape, reward, cols, chunks)
    parts = torch.empty((1, B), dtype=torch.float32, device=reward.device)
    with torch.cuda.device(reward.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.library().cdll.upgo_loss_f32(
            rhos.data_ptr(), lp.data_ptr(), reward.data_ptr(),
            value.data_ptr(), parts.data_ptr(), T, B, *tiling, stream)
    _build.check_status("upgo_loss", status)
    upgo_loss.launches += 1
    # One partial per column, summed by torch.sum in a fixed order: no float
    # atomics, so repeated runs are bitwise equal.
    return -parts.sum() / (T * B)


class _UpgoLossFunction(torch.autograd.Function):
    """upgo_loss with the recompute backward of rl_scans.py:452-465."""

    @staticmethod
    def forward(ctx, rhos, lp, reward, value):
        ctx.save_for_backward(rhos, reward, value)
        return _upgo_loss_forward(rhos, lp, reward, value)

    @staticmethod
    def backward(ctx, ct):
        rhos, reward, value = ctx.saved_tensors
        adv = upgo_advantages(rhos, reward, value)
        dlp = (-ct / reward.numel()) * adv
        zeros = [torch.zeros_like(t) if ctx.needs_input_grad[i] else None
                 for i, t in ((0, rhos), (2, reward), (3, value))]
        return zeros[0], dlp, zeros[1], zeros[2]


def upgo_loss(rhos, lp, reward, value):
    """UPGO loss -mean(rhos * (upgo_returns - value[:-1]) * lp): the binary
    lambdas, the return recurrence, the advantage and the loss sum in one
    kernel pass, from rhos, lp, reward (T, B) and value (T+1, B).  CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    Differentiable in lp (d/d lp = -adv/TB, the advantage recomputed by
    `upgo_advantages`); rhos, reward and value get zeros."""
    return _UpgoLossFunction.apply(rhos, lp, reward, value)


upgo_loss.launches = 0
