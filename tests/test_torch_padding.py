"""The port's ragged-batch padding (di_hpc_tpu_torch.ops.padding and
origin.padding, and the C host core they call) against the JAX package's
ops.padding and origin.padding, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the port
returns tensors on device="cpu".  Tolerance: none -- padding copies, so the
batches, masks and shapes must be equal bit for bit, and the bucketing DP's
split points equal the JAX Python DP's.
"""

import ctypes
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin

from di_hpc_tpu_torch import ops, origin
from di_hpc_tpu_torch.ops import padding as port_padding
from di_hpc_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]
PADS = {1: "Padding1D", 2: "Padding2D", 3: "Padding3D"}
UNPADS = {1: "UnPadding1D", 2: "UnPadding2D", 3: "UnPadding3D"}


def _ragged(seed, n, ndim, lo, hi, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(int(d) for d in rng.integers(
        lo, hi, ndim))).astype(dtype) for _ in range(n)]


def _equal(got, want):
    """A port tensor equals a JAX (or numpy) array bit for bit, dtype too
    (both narrow float64 to float32 and int64 to int32 at the transfer)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _check_result(got, want, group):
    """(padded, mask, shapes) or, grouped, three tuples over the buckets."""
    if group == 1:
        got, want = [[g] for g in got], [[w] for w in want]
    assert len(got[0]) == len(want[0])
    for gp, gm, gs, wp, wm, ws in zip(*got, *want):
        _equal(gp, wp)
        _equal(gm, wm)
        assert list(gs) == list(ws)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("group,mode", [(1, "sample"), (4, "sample"),
                                        (4, "oracle")])
@pytest.mark.parametrize("side", ["ops", "origin"])
def test_padding_matches_jax(ndim, group, mode, side):
    data = _ragged(ndim * 10 + group, 13, ndim, 2, 9)
    port_mod, jax_mod = {"ops": (ops, jax_ops),
                         "origin": (origin, jax_origin)}[side]
    try:
        want = getattr(jax_mod, PADS[ndim])(
            data, group=group, group_mode=mode,
            rng=np.random.default_rng(7))
    except AssertionError:
        # The origin's by-shape pivots can crash; the port must crash alike.
        with pytest.raises(AssertionError):
            getattr(port_mod, PADS[ndim])(
                data, group=group, group_mode=mode,
                rng=np.random.default_rng(7), device="cpu")
        return
    got = getattr(port_mod, PADS[ndim])(
        data, group=group, group_mode=mode, rng=np.random.default_rng(7),
        device="cpu")
    _check_result(got, want, group)
    # CPU tensors take the same host route and give the same bits.
    again = getattr(port_mod, PADS[ndim])(
        [torch.from_numpy(a) for a in data], group=group, group_mode=mode,
        rng=np.random.default_rng(7), device="cpu")
    _check_result(again, want, group)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("deepcopy", [False, True])
def test_unpadding_matches_jax(ndim, deepcopy):
    data = _ragged(30 + ndim, 9, ndim, 2, 8)
    padded, mask, shapes = getattr(ops, PADS[ndim])(data, device="cpu")
    j_padded, _, j_shapes = getattr(jax_ops, PADS[ndim])(data)
    got = getattr(ops, UNPADS[ndim])(padded, shapes, deepcopy=deepcopy)
    want = getattr(jax_ops, UNPADS[ndim])(j_padded, j_shapes,
                                         deepcopy=deepcopy)
    for g, w, x in zip(got, want, data):
        _equal(g, w)
        _equal(g, x)
    # deepcopy gives copies; without it the items are views of the batch.
    got[0].fill_(123.0)
    assert bool((padded[0] == 123.0).any()) is not deepcopy
    # Buckets back to the inputs, in the sorted order of the buckets.
    xs, _, bucket_shapes = getattr(ops, PADS[ndim])(
        data, group=3, group_mode="oracle", device="cpu")
    out = getattr(ops, UNPADS[ndim])(list(xs), list(bucket_shapes),
                                     deepcopy=deepcopy)
    order = sorted(range(len(data)), key=lambda i: data[i].size)
    for g, i in zip(out, order):
        _equal(g, data[i])


class _Shape:
    def __init__(self, n):
        self.shape = (n,)


@pytest.mark.parametrize("seed", range(6))
def test_oracle_dp_in_c_matches_jax_python_dp(seed):
    """The port's C DP against the JAX package's Python DP: the same split
    points and shapes, ties included (small integer numels tie often)."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        n = int(rng.integers(1, 30))
        group = int(rng.integers(1, min(n, 7) + 1))
        numels = sorted(int(v) for v in rng.integers(1, 12, n))
        x = [_Shape(v) for v in numels]
        want = jax_origin.oracle_split_group(x, group)
        assert ops.oracle_split_group(x, group) == want
        assert origin.oracle_split_group(x, group) == want


def test_oracle_dp_refuses_more_groups_than_items():
    with pytest.raises(ValueError, match="cannot split 2 items into 3"):
        ops.oracle_split_group([_Shape(1), _Shape(2)], 3)


class _FixedRng:
    """A generator whose choice() always samples these indices."""

    def __init__(self, idx):
        self.idx = np.asarray(idx)

    def choice(self, n, k):
        return self.idx[:k]


def test_pivot_dedupe_by_shape_in_origin_and_by_numel_in_ops():
    """Two sampled pivots of one numel: the origins (deduped by shape, as
    the reference) crash on their bucket-count assert; the ops (deduped by
    numel) split into two buckets; each side as the JAX package's."""
    shapes = [(2, 6), (3, 4), (4, 3), (6, 2), (5, 5)]
    data = [np.ones(s, np.float32) for s in shapes]
    for mod in (origin, jax_origin):
        with pytest.raises(AssertionError):
            kwargs = {"device": "cpu"} if mod is origin else {}
            mod.Padding2D(data, group=3, rng=_FixedRng([0, 1]), **kwargs)
    want = jax_ops.sample_split_group(data, 3, rng=_FixedRng([0, 1]))
    assert ops.sample_split_group(data, 3, rng=_FixedRng([0, 1])) == want
    assert want == ([(3, 4), (5, 5)], [0, 4, 5])
    got = ops.Padding2D(data, group=3, rng=_FixedRng([0, 1]), device="cpu")
    _check_result(got, jax_ops.Padding2D(data, group=3,
                                         rng=_FixedRng([0, 1])), 3)


@pytest.mark.parametrize("make", [
    lambda s: _ragged(s, 7, 2, 2, 6, np.int32),
    lambda s: _ragged(s, 7, 2, 2, 6, np.float64),
    lambda s: _ragged(s, 7, 1, 2, 6, np.float16),
    # float32, but a transposed (non-contiguous) view: the numpy route.
    lambda s: [a.T for a in _ragged(s, 7, 2, 2, 6)],
    # mixed dtypes: the numpy route in the first item's dtype.
    lambda s: _ragged(s, 3, 1, 2, 6) + _ragged(s + 1, 3, 1, 2, 6, np.float64),
])
def test_inputs_off_the_c_pack_keep_their_dtype(make):
    """The numpy route packs in the first item's dtype, and the batch and
    mask land in JAX's dtype for it: int32, float16 and float32 as they
    are, float64 as float32."""
    data = make(5)
    for group in (1, 2):
        got = ops.Padding2D(data, group=group, group_mode="oracle",
                            device="cpu") if data[0].ndim == 2 else \
            ops.Padding1D(data, group=group, group_mode="oracle",
                          device="cpu")
        pad = jax_ops.Padding2D if data[0].ndim == 2 else jax_ops.Padding1D
        _check_result(got, pad(data, group=group, group_mode="oracle"),
                      group)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
@pytest.mark.parametrize("group,mode", [(1, "sample"), (3, "oracle")])
@pytest.mark.parametrize("side", ["ops", "origin"])
def test_64_bit_inputs_land_as_jax_narrows_them(ndim, dtype, group, mode,
                                                 side):
    """float64 items give a float32 batch and mask, int64 items int32 ones,
    as JAX's jnp.asarray gives them, from numpy and from CPU tensors; the
    bits are JAX's."""
    data = [a.astype(dtype) if dtype == np.float64
            else np.round(4 * a).astype(dtype)
            for a in _ragged(70 + ndim, 9, ndim, 2, 7)]
    port_mod, jax_mod = {"ops": (ops, jax_ops),
                         "origin": (origin, jax_origin)}[side]
    kw = dict(group=group, group_mode=mode, value=0.1 if dtype == np.float64
              else 2)
    want = getattr(jax_mod, PADS[ndim])(data, rng=np.random.default_rng(3),
                                        **kw)
    narrow = {np.float64: torch.float32, np.int64: torch.int32}[dtype]
    for items in (data, [torch.from_numpy(a) for a in data]):
        got = getattr(port_mod, PADS[ndim])(
            items, rng=np.random.default_rng(3), device="cpu", **kw)
        _check_result(got, want, group)
        batches = [got[0]] if group == 1 else list(got[0])
        masks = [got[1]] if group == 1 else list(got[1])
        assert {t.dtype for t in batches + masks} == {narrow}


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.float64, torch.int64])
def test_pack_for_card_inputs_gives_the_host_route_bits(ndim, dtype):
    """The pack that CUDA inputs take (one batch, one slice copy per item),
    run here on CPU tensors, against the host route: the same dtype
    (float64 and int64 narrowed to float32 and int32) and bits."""
    data = [torch.from_numpy(a).to(dtype)
            for a in _ragged(50 + ndim, 11, ndim, 1, 7)]
    got = port_padding._pad_on_card(data, 0.5 if dtype.is_floating_point
                                    else 3, ndim)
    want = getattr(ops, PADS[ndim])(data, value=0.5 if dtype.is_floating_point
                                    else 3, device="cpu")
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == narrow.get(dtype, dtype)
        assert torch.equal(g, w)
    assert got[2] == want[2]


def _is_f32_probe(source: Path, tmp_path: Path, tag: str):
    """is_f32 of a copy of hostcore.c, built with a probe entry point."""
    probe = tmp_path / f"probe_{tag}.c"
    probe.write_text(f'#include "{source}"\n'
                     "int probe_is_f32(Py_ssize_t itemsize, const char *f)"
                     " { Py_buffer b = {0}; b.itemsize = itemsize;"
                     " b.format = (char *)f; return is_f32(&b); }\n")
    so = tmp_path / f"probe_{tag}.so"
    subprocess.run(["gcc", "-shared", "-fPIC",
                    f"-I{sysconfig.get_paths()['include']}", str(probe),
                    "-o", str(so)], check=True, capture_output=True,
                   timeout=120)
    fn = ctypes.CDLL(str(so)).probe_is_f32
    fn.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p]
    return fn


def test_copied_is_f32_rejects_a_format_less_buffer(tmp_path):
    """A buffer that names no format holds bytes: the port's copy refuses a
    4-byte one, where the JAX package's csrc/hostcore.c takes it."""
    port = _is_f32_probe(native.HOST_SRC / "hostcore.c", tmp_path, "port")
    jax_copy = _is_f32_probe(ROOT / "csrc" / "hostcore.c", tmp_path, "jax")
    assert port(4, None) == 0 and jax_copy(4, None) == 1
    assert port(4, b"f") == 1
    assert port(4, b"i") == 0 and port(8, b"f") == 0
    ext = native.get_native_ext()
    with pytest.raises(ValueError, match="float32"):
        ext.pack_padded([np.zeros(3, np.int32)], np.empty((1, 3), np.float32),
                        np.empty((1, 3), np.float32), 0.0)


def test_host_core_builds_at_once_in_threads_and_raises_on_errors(
        tmp_path, monkeypatch):
    """Builds started together end with one complete library; a source that
    does not compile raises with the compiler's message."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    src = native.HOST_SRC / "bucketing.cpp"
    paths, errors = [], []

    def build():
        try:
            paths.append(native._build(src, "g++", ["-O2", "-std=c++17"]))
        except Exception as e:       # reported below
            errors.append(e)

    threads = [threading.Thread(target=build, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    assert lib.oracle_split_group is not None

    bad = tmp_path / "bad.c"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="host core build failed"):
        native._build(bad, "gcc", [])
