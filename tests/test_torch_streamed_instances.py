"""The streamed plain pair's compile-time instances: the C entry points'
case lists against the Python lists that name them (shapes and ring
depths), the forward template's one home in a header both sources
include, its ring's shared memory, the kernels' names, and the new
wrappers' refusals on the CPU; then the plain halves against
the JAX package's scan reference at the GRU fleet's and cartpole's stages
and horizons, the shapes the new instances take.  The instances
themselves are held against the plain versions and the run-time kernels
on a card by tests/test_torch_cuda.py and chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyneuralempc_tpu.solve.riccati import riccati_sweep_ref
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import sweep_case

import _torch_threads  # noqa: F401  (one torch thread)

CSRC = Path(__file__).resolve().parents[1] / "pyneuralempc_tpu_torch" / "csrc"
STREAMED = (CSRC / rk.STREAMED_SOURCE).read_text()
GENERAL = (CSRC / rk.GENERAL_SOURCE).read_text()
HEADER = (CSRC / "riccati_forward_fixed.cuh").read_text()
PLAIN_INSTANCES = {(12, 4), (10, 1), (4, 1)}
# the forward instances: those stages, the wide fleet's (12, 10) and the
# quadrotor GRU's lifted (28, 4); the backward ones: the same and the LSTM
# fleet's lifted (18, 1)
FORWARD_SHAPES = PLAIN_INSTANCES | {(12, 10), (28, 4)}
BACKWARD_SHAPES = FORWARD_SHAPES | {(18, 1)}
SMEM_PER_SM = 228 * 1024     # an H100 SM's shared memory
SMEM_RESERVED = 1024         # the runtime's reserve a block


def _cases(macro, text, n):
    return [tuple(map(int, t)) for t in re.findall(
        rf"^\s*{macro}\(" + ", ".join([r"(\d+)"] * n) + r"\)\s*$", text,
        re.M)]


def test_forward_instances_match_the_c_entry_point():
    """riccati_forward_f32's list names each instance's ring depth, and is
    exactly _FORWARD_INSTANCES (shape -> depth): the quadrotor's, the GRU
    fleet's, cartpole's, the wide fleet's and the quadrotor GRU's stages;
    riccati_backward_f32's list is exactly _BACKWARD_INSTANCES, the same
    five stages and the LSTM fleet's (18, 1)."""
    cases = _cases("RICCATI_FORWARD_CASE", STREAMED, 3)
    assert {(nx, nu): d for nx, nu, d in cases} == rk._FORWARD_INSTANCES
    assert len(cases) == len(rk._FORWARD_INSTANCES)
    assert set(rk._FORWARD_INSTANCES) == FORWARD_SHAPES
    bwd = _cases("RICCATI_BACKWARD_CASE", STREAMED, 2)
    assert set(bwd) == BACKWARD_SHAPES == set(rk._BACKWARD_INSTANCES)
    assert BACKWARD_SHAPES - FORWARD_SHAPES == {(18, 1)}
    assert len(bwd) == len(rk._BACKWARD_INSTANCES)
    entry = STREAMED[STREAMED.index('int riccati_forward_f32('):]
    assert "int depth" not in entry[:entry.index("{")]
    assert 'extern "C" int riccati_forward_runtime_f32(' in STREAMED


def test_general_backward_instances_as_before():
    """The general backward entry keeps its one instance, (12, 4, 2, 1), and
    both entries launch the backward template at the same four template
    arguments: neither takes a run-time switch or depth."""
    cases = _cases("RICCATI_GENERAL_BACKWARD_CASE", GENERAL, 4)
    assert cases == [(12, 4, 2, 1)]
    assert rk._GENERAL_BACKWARD_INSTANCES == {(12, 4, 2, 1)}
    assert "backward_fixed<NX_, NU_, R_, RE_>(" in GENERAL
    assert "backward_fixed<NX_, NU_, 1, 0>(" in STREAMED
    for entry in re.findall(r'extern "C" int (\w+)\(', STREAMED):
        assert entry in {"riccati_backward_f32", "riccati_backward_runtime_f32",
                         "riccati_forward_f32", "riccati_forward_runtime_f32"}


def test_general_forward_instances_as_before():
    """The general forward entry keeps its one instance, (12, 4, 2, 1) at
    depth 2."""
    cases = _cases("RICCATI_GENERAL_FORWARD_CASE", GENERAL, 5)
    assert cases == [(12, 4, 2, 1, 2)]
    assert rk._GENERAL_FORWARD_INSTANCES == {(12, 4, 2, 1): 2}


def test_forward_template_lives_in_one_header():
    """riccati_general_forward_fixed, its layout, copies and launcher are
    defined in csrc/riccati_forward_fixed.cuh alone, which both streamed
    sources include."""
    for text in (STREAMED, GENERAL):
        assert '#include "riccati_forward_fixed.cuh"' in text
    defs = (r"^riccati_general_forward_fixed\(", r"^struct ForwardLayout \{",
            r"^cudaError_t forward_fixed\(",
            r"^__device__ __forceinline__ void ring_copy\(",
            r"^__device__ __forceinline__ int phase16\(",
            r"^__device__ __forceinline__ void copy_short_async\(",
            r"^__host__ __device__ constexpr int forward_ring_floats\(")
    for d in defs:
        assert len(re.findall(d, HEADER, re.M)) == 1, d
        for text in (STREAMED, GENERAL):
            assert not re.search(d, text, re.M), d
    assert "template <int NX, int NU, int R, int RE, int D>" in HEADER
    assert "kForwardRing" not in HEADER + STREAMED + GENERAL


@pytest.mark.parametrize("nx,nu,floats", [(12, 4, 476), (10, 1, 272),
                                          (4, 1, 68), (12, 10, 700),
                                          (28, 4, 1980)])
def test_forward_slot_floats_hand_worked(nx, nu, floats):
    """One stage slot at one right-hand side and no equality rows: A, B, c
    and the gains, each with 3 floats of room for its source's offset,
    rounded to 16 bytes (at (4, 1): 20 + 8 + 8 + 32; at (12, 10): 148 +
    124 + 16 + 412; at (28, 4): 788 + 116 + 32 + 1,044, the gains K 112,
    k 4, Pbar 784, pbar 28 and Mxu 112)."""
    assert rk.forward_slot_floats(nx, nu, 1, 0) == floats


@pytest.mark.parametrize("shape", sorted(FORWARD_SHAPES))
def test_each_ring_fits_eight_blocks(shape):
    """At its depth (and at the cap) a block of four warps' rings leaves
    room for eight blocks an SM, as __launch_bounds__(128, 8) asks; the
    next depth past the cap would not.  At the quadrotor GRU's (28, 4) no
    depth leaves room for eight (a 7,920-byte slot a warp): its depth 3
    leaves room for two blocks an SM."""
    nx, nu = shape
    if shape == (28, 4):
        assert 8 * (rk.forward_ring_bytes(28, 4, 1, 0, 1)
                    + SMEM_RESERVED) > SMEM_PER_SM
        depth = rk._FORWARD_INSTANCES[shape]
        assert depth == 3 and SMEM_PER_SM // (
            rk.forward_ring_bytes(28, 4, 1, 0, depth) + SMEM_RESERVED) == 2
        return
    cap = {(12, 4): 3, (10, 1): 6, (4, 1): 25, (12, 10): 2}[shape]
    for depth in (rk._FORWARD_INSTANCES[shape], cap):
        assert depth <= cap
        assert 8 * (rk.forward_ring_bytes(nx, nu, 1, 0, depth)
                    + SMEM_RESERVED) <= SMEM_PER_SM
    assert 8 * (rk.forward_ring_bytes(nx, nu, 1, 0, cap + 1)
                + SMEM_RESERVED) > SMEM_PER_SM


# FixedLayout's shared memory a warp, worked by hand from its offsets:
# (12, 4, 1, 0) two 528-float stage buffers (X 12 x 20, G and M 136 each,
# mx 12, mu 4) and 552 floats of scratch (P_new 156, p 12, Y 240, Z 80, W
# 64); (10, 1, 1, 0) 2 x 264 + 268; (4, 1, 1, 0) 2 x 68 + 72; (12, 4, 2, 1)
# 2 x 564 + 580; (12, 10, 1, 0) one 816-float buffer (X 12 x 24, G and M
# 253 each, mx 12, mu 10) and 856 of scratch (156 + 12 + Y 288 + Z 240 + W
# 160): two buffers would take 9,952 bytes, and 8 blocks of 4 warps would
# need 8 x (4 x 9,952 + 1,024) = 326,656 > 233,472; (18, 1, 1, 0) one
# 760-float buffer (X 18 x 20, G and M 190 each, mx 18, mu 1: 759) and 764
# of scratch (P_new 18 x 19 = 342 -> 344, p 20, Y 360, Z 20, W 20): two
# buffers would take 9,136 bytes, 8 x (4 x 9,136 + 1,024) = 300,544;
# (28, 4, 1, 0) one 2,096-float buffer (X 28 x 36, G and M 528 each, mx 28,
# mu 4) and 2,120 of scratch (P_new 28 x 29 = 812, p 28, Y 1,008, Z 144, W
# 128): 16,864 bytes, so a block of 4 warps takes 67,456 and 3 blocks fit
# an SM (3 x 68,480 = 205,440), 4 do not.
@pytest.mark.parametrize("shape,buffers,nbytes", [
    ((12, 4, 1, 0), 2, 6432), ((10, 1, 1, 0), 2, 3184),
    ((4, 1, 1, 0), 2, 832), ((12, 4, 2, 1), 2, 6832),
    ((12, 10, 1, 0), 1, 6688), ((18, 1, 1, 0), 1, 6096),
    ((28, 4, 1, 0), 1, 16864)])
def test_backward_fixed_smem_hand_worked(shape, buffers, nbytes):
    """backward_fixed_smem_bytes mirrors FixedLayout::kFloats: the header's
    own numbers, and at (12, 10), (18, 1) and (28, 4) one stage buffer;
    every backward instance (the plain and the general entries') but the
    quadrotor GRU's leaves room for 8 blocks of 4 warps an SM, as
    __launch_bounds__(128, 8) asks (B=4096 in one wave on 132 SMs); that
    one's, past the 8 blocks' 7,040 bytes a warp, for 3."""
    assert rk.backward_fixed_buffers(*shape) == buffers
    assert rk.backward_fixed_smem_bytes(*shape) == nbytes
    instances = ({(nx, nu, 1, 0) for nx, nu in rk._BACKWARD_INSTANCES}
                 | set(rk._GENERAL_BACKWARD_INSTANCES))
    assert shape in instances
    for s in instances:
        block = rk.STREAMED_WARPS * rk.backward_fixed_smem_bytes(*s)
        fits = SMEM_PER_SM // (block + SMEM_RESERVED)
        assert fits == 3 if s == (28, 4, 1, 0) else fits >= 8, s
    if buffers == 1:   # a second stage buffer (816 floats at (12, 10),
        # 760 at (18, 1), 2,096 at (28, 4)) would not fit 8 blocks
        stage = rk._fixed_stage_floats(*shape)
        assert stage == {(12, 10, 1, 0): 816, (18, 1, 1, 0): 760,
                         (28, 4, 1, 0): 2096}[shape]
        assert 8 * (4 * (nbytes + 4 * stage) + SMEM_RESERVED) > SMEM_PER_SM


def _designs():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_backward_designs.py"
    spec = importlib.util.spec_from_file_location("chip_backward_designs",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return path, mod


DESIGNS = {(12, 10): ["two buffers", "7-block cap", "lane kept",
                      "triangles unfolded", "Z rolled"],
           (18, 1): ["one lane a row", "7-block cap",
                     "one lane a row, 7-block cap", "lane kept",
                     "triangles unfolded"]}


@pytest.mark.parametrize("stage,name", [(s, n) for s, names in DESIGNS.items()
                                        for n in names])
def test_backward_designs_edit_the_header_once(stage, name):
    """chip_backward_designs.py makes each other design of the (12, 10) and
    the (18, 1) backward instances by text edits of the committed header
    (one each but where the name joins two): the text each replaces is
    there exactly once, and each edit changes it."""
    _, mod = _designs()
    header = (CSRC / mod.HEADER).read_text()
    assert set(mod.DESIGNS) == set(DESIGNS)
    assert set(mod.DESIGNS[stage]) == {"instance", *DESIGNS[stage]}
    assert mod.DESIGNS[stage]["instance"] is None
    edits = mod.DESIGNS[stage][name]
    assert len(edits) == (2 if "," in name else 1)
    for old, new in edits:
        assert header.count(old) == 1 and new not in header


def test_backward_designs_refuse_without_a_card():
    """No CUDA device: chip_backward_designs.py exits non-zero and prints no
    result."""
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _ = _designs()
    out = subprocess.run([sys.executable, str(path)], cwd=path.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"turns_ms"' not in out.stdout


@pytest.mark.parametrize("nx,nu", [(12, 4), (10, 1), (4, 1), (4, 2),
                                   (12, 10), (32, 16), (28, 4)])
def test_forward_kernel_rule(nx, nu):
    """The forward instance, named with its template arguments (its ring
    depth last), at the instances' shapes; the run-time kernel at any
    other; no name holds another, across shapes and the general
    instance."""
    name = rk.forward_kernel(nx, nu)
    if (nx, nu) in FORWARD_SHAPES:
        d = rk._FORWARD_INSTANCES[nx, nu]
        assert name == f"riccati_general_forward_fixed<{nx}, {nu}, 1, 0, {d}>"
    else:
        assert name == "riccati_forward_kernel"
    names = ["riccati_forward_kernel", "riccati_general_forward_kernel",
             rk.general_forward_kernel(12, 4, 2, 1)]
    names += [rk.forward_kernel(a, b) for a, b in sorted(FORWARD_SHAPES)]
    for a in names:
        for b in names:
            assert a == b or a.replace(" ", "") not in b.replace(" ", "")


def test_lstm_stage_takes_the_backward_instance():
    """At the LSTM fleet's lifted (18, 1), H=100, the streamed plan names
    the backward instance riccati_general_backward_fixed<18, 1, 1, 0> (past
    nx = 16: one stage buffer, 6,096 B a warp) and the run-time forward
    kernel, as backward_kernel and forward_kernel do: the backward list has
    (18, 1), the forward list has not."""
    plan = rk.kernel_plan(100, 18, 1, "cuda")
    assert plan["path"] == "cuda_streamed"
    assert plan["backward_kernel"] == rk.backward_kernel(18, 1) == (
        "riccati_general_backward_fixed<18, 1, 1, 0>")
    assert plan["forward_kernel"] == rk.forward_kernel(18, 1) == (
        "riccati_forward_kernel")
    assert (18, 1) in rk._BACKWARD_INSTANCES
    assert (18, 1) not in rk._FORWARD_INSTANCES
    assert (rk.backward_fixed_buffers(18, 1, 1, 0),
            rk.backward_fixed_smem_bytes(18, 1, 1, 0)) == (1, 6096)
    assert rk.kernel_plan(100, 18, 1, "cpu")["path"] == "plain"


def test_gru_quadrotor_stage_takes_the_backward_instance():
    """At the quadrotor GRU's lifted (28, 4), H=100, the streamed plan names
    the backward instance riccati_general_backward_fixed<28, 4, 1, 0> (the
    tall tiles at nu = 4: one stage buffer, 16,864 B a warp) and the
    forward instance riccati_general_forward_fixed<28, 4, 1, 0, 3>: both
    lists have (28, 4), and nothing falls back."""
    plan = rk.kernel_plan(100, 28, 4, "cuda")
    assert plan["path"] == "cuda_streamed"
    assert plan["backward_kernel"] == rk.backward_kernel(28, 4) == (
        "riccati_general_backward_fixed<28, 4, 1, 0>")
    assert plan["forward_kernel"] == rk.forward_kernel(28, 4) == (
        "riccati_general_forward_fixed<28, 4, 1, 0, 3>")
    assert (28, 4) in rk._BACKWARD_INSTANCES
    assert rk._FORWARD_INSTANCES[28, 4] == 3
    assert (rk.backward_fixed_buffers(28, 4, 1, 0),
            rk.backward_fixed_smem_bytes(28, 4, 1, 0)) == (1, 16864)


def test_new_wrappers_refuse_cpu_tensors():
    """The run-time forward wrapper and the forward wrapper at an instance's
    shape launch only on CUDA tensors; a refused call moves no counter."""
    t = [torch.as_tensor(a) for a in sweep_case("delta0", B=2, H=3, nx=4,
                                                 nu=1)]
    gains, _ = rk.riccati_backward_plain(*t)
    fwd = (t[0], t[1], t[6], gains)

    def counts():
        return (rk.FORWARD_LAUNCHES, rk.FORWARD_INSTANCE_LAUNCHES,
                rk.FORWARD_RUNTIME_LAUNCHES,
                rk.BACKWARD_LAUNCHES, rk.BACKWARD_INSTANCE_LAUNCHES,
                rk.BACKWARD_RUNTIME_LAUNCHES)

    n0 = counts()
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_forward_runtime_cuda(*fwd)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_forward_cuda(*fwd)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_backward_runtime_cuda(*t)
    with pytest.raises(ValueError, match="CUDA device"):
        rk.riccati_backward_cuda(*t)
    assert counts() == n0


SPLIT_TOL = 2e-4    # tests/test_pallas_kernel.py's quadrotor-dims tolerance


@pytest.mark.parametrize("nx,H", [(10, 100), (4, 50), (18, 100)])
@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_plain_halves_match_reference_at_path_horizons(kind, nx, H):
    """At the GRU fleet's lifted (10, 1), H=100, cartpole's (4, 1), H=50 and
    the LSTM fleet's lifted (18, 1), H=100 (the stages and horizons the
    backward instances take on the card),
    riccati_backward_plain then riccati_forward_plain against the JAX
    package's scan reference (vmapped) on the seeded cases: ok flags
    equal, outputs of the ok problems within SPLIT_TOL·max(1, |ref|)."""
    args = sweep_case(kind, B=4, H=H, nx=nx, nu=1, seed=nx)
    t = [torch.as_tensor(a) for a in args]
    gains, ok = rk.riccati_backward_plain(*t)
    out = rk.riccati_forward_plain(t[0], t[1], t[6], gains)
    ref = jax.vmap(riccati_sweep_ref)(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[3]))
    want = [True, False, True, False] if kind == "negative_curvature" else [
        True] * 4
    assert ok.tolist() == want
    m = ok.numpy()
    for o, r in zip(out, ref[:3]):
        r = np.asarray(r)[m]
        err = np.abs(o.numpy()[m] - r) / np.maximum(1.0, np.abs(r))
        assert err.max() <= SPLIT_TOL, err.max()


@pytest.mark.parametrize("kind", ["delta0", "delta_per_problem",
                                  "negative_curvature", "local_bump"])
def test_plain_halves_match_reference_at_the_gru_quadrotor_stage(kind):
    """At the quadrotor GRU's lifted (28, 4), H=100 (the stage and horizon
    its backward instance takes on the card), riccati_backward_plain then
    riccati_forward_plain against the JAX package's scan reference
    (vmapped) on the seeded cases: ok flags equal, outputs of the ok
    problems within SPLIT_TOL·max(1, |ref|)."""
    args = sweep_case(kind, B=4, H=100, nx=28, nu=4, seed=28)
    t = [torch.as_tensor(a) for a in args]
    gains, ok = rk.riccati_backward_plain(*t)
    out = rk.riccati_forward_plain(t[0], t[1], t[6], gains)
    ref = jax.vmap(riccati_sweep_ref)(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[3]))
    want = [True, False, True, False] if kind == "negative_curvature" else [
        True] * 4
    assert ok.tolist() == want
    m = ok.numpy()
    for o, r in zip(out, ref[:3]):
        r = np.asarray(r)[m]
        err = np.abs(o.numpy()[m] - r) / np.maximum(1.0, np.abs(r))
        assert err.max() <= SPLIT_TOL, err.max()
