"""dpt_tpu_torch walk probes ≡ the JAX probe scripts they port.

  - P5 (`probe_interleave`) and P6 (`probe_interleave_any`): the plain
    version against the JAX probe at 16 steps, P = 1 and 2, allclose at
    rtol 1e-6, atol 1e-6 (bit-equal here).
  - P2 (`probe_interleave2`): variants A-D at P = 1 and 2; A allclose as
    above, B-D exactly zero in both packages; the sink (final sp, top of
    the stack, mt8 ok count) against a per-chain scalar loop.
  - P1 (`r3_smem_proto`): the plain walk against `smem_nearest` on a
    400-triangle procedural scene (SAH leaf 8, the JAX tables carried
    across) at 16² rays, at every staged prefix up to the whole table: t
    allclose at rtol 1e-6 after min(t, T_MAX), tri exact on a stream
    without equal-t ties; the host's level starts; the record layout over
    a cluster (`plan`, `home`) on that table and on the flagship's level
    starts, given as numbers; a scene with one huge triangle planted where
    the leaf test's 1 / det is subnormal, whose hits the plain walk finds
    at the plane's distance.

The probe modules' imports (no jax, no dpt_tpu; the render path imports
no probe) are checked with the package's, in
tests/test_torch_scene.py::test_import_leaves_jax_out.

The JAX probes run as they stand, on the CPU: P1 interprets on its own,
P5, P6 and P2 through `pallas_call(..., interpret=True)` and ITERS = 16,
patched in for the module.  Each JAX probe runs once, at P = 2, and its
chains are independent, so chain 0 is the probe at P = 1 on the first six
ray tiles: the port at P = 1 is held against it, and at P = 2 against
both chains.  Tests marked `cuda` compare each kernel with its plain
version on the card, bit for bit (P5, P6 and P2 in the shape the library
takes), and check that the C side refuses other grids; they skip without
one; P1 also in forced cluster sizes and replications, on the planted
scene (its IEEE redo, against K1 lane too), its reciprocal on every
float32 of its input range, and the C side's refusals.  The CPU
also checks the shapes of P5, P6 and P2, the wrappers' refusal of a shape
(P5 / P6, P1), P or variant the kernel does not take (P2's before the
library is loaded), and the SASS step- and leaf-loop finder the shape
scripts share (`probes.sass`).
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dpt_tpu_torch.kernels.quad import _leaf_tests
from dpt_tpu_torch.probes import probe_interleave as tp5
from dpt_tpu_torch.probes import probe_interleave2 as tp2
from dpt_tpu_torch.probes import probe_interleave_any as tp6
from dpt_tpu_torch.probes import r3_smem_proto as tp1

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITERS = 16
# probe name -> (JAX script, port module)
INTERLEAVE = {
    "P5": ("scripts/probe_interleave.py", tp5),
    "P6": ("scripts/attic/probe_interleave_any.py", tp6),
}


def _script(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_" + pathlib.Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    """jax_probe(script, *make_args) -> the JAX probe's P = 2 tiles on its
    inputs (`_INPUTS`), with the probe's pallas_call in interpret mode and
    ITERS steps; each (script, make_args) runs once for the module."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    runs = {}

    def run(rel, *make_args):
        if (rel, make_args) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True))
                mod = _script(rel)
                mp.setattr(mod, "ITERS", ITERS)
                runs[rel, make_args] = _jax_tiles(
                    mod.make(2, *make_args), *_INPUTS[rel]())
        return runs[rel, make_args]

    return run


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _interleave_inputs(P, seed=0):
    rng = np.random.default_rng(seed)
    return tp5.node_tables(rng)[0], tp5.ray_tiles(rng, P)


def _interleave2_inputs(P, seed=0):
    rng = np.random.default_rng(seed)
    nodes, tris = tp2.tables(rng)[0]
    rays = [rng.normal(size=(8, 128)).astype(np.float32)
            for _ in range(P * 6)]
    return nodes, tris, rays


def _jax_tiles(go, *arrays):
    import jax.numpy as jnp

    return [np.asarray(x) for x in go(*(jnp.asarray(a) for a in arrays))]


def _jax_inputs_interleave():
    nodes, rays = _interleave_inputs(2, seed=2)
    return (nodes, *rays)


def _jax_inputs_interleave2():
    nodes, tris, rays = _interleave2_inputs(2, seed=12)
    return (nodes, tris, *rays)


# JAX script -> its inputs at P = 2 (the tables, then 12 ray tiles)
_INPUTS = {
    "scripts/probe_interleave.py": _jax_inputs_interleave,
    "scripts/attic/probe_interleave_any.py": _jax_inputs_interleave,
    "scripts/attic/probe_interleave2.py": _jax_inputs_interleave2,
}


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("probe", sorted(INTERLEAVE))
def test_interleave_matches_jax(jax_probe, probe, P):
    script, port = INTERLEAVE[probe]
    nodes, *rays = _INPUTS[script]()
    rays = rays[:6 * P]
    want = jax_probe(script)[:P]
    tiles, sink = port.make(P, iters=ITERS)(
        torch.as_tensor(nodes), *map(torch.as_tensor, rays))
    assert len(want) == len(tiles) == P
    for w, got in zip(want, tiles):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)
    # the sink holds each chain's final record
    assert sink[:, 0].eq(0).all() and sink[:, 2].eq(0).all()
    assert ((sink[:, 1] >= 0) & (sink[:, 1] < tp5.N_RECORDS)).all()


@pytest.mark.parametrize("P", tp5.PS)
@pytest.mark.parametrize("any_in_index", [False, True])
def test_interleave_shape_rule(any_in_index, P):
    """The shape the wrapper launches is built, covers the 1,024 tile
    elements once, and is one cluster of 2-8 blocks (the portable sizes)
    for P6, none for P5."""
    T, S = tp5.shape(P, any_in_index)
    assert (T, S) == tp5.SHAPE[any_in_index]
    assert T % 32 == 0 and T * tp5.blocks((T, S)) == tp5.TILE
    if any_in_index:
        assert 2 <= S <= 8 and S == tp5.blocks((T, S))
    else:
        assert S == 1 and tp5.blocks((T, S)) > 1


@pytest.mark.parametrize("any_in_index, P, shape", [
    (False, 1, (1024, 1)),  # the one-block kernel left the library
    (False, 2, (64, 2)),  # P5 takes no cluster
    (True, 1, (1024, 1)),  # P6 needs a cluster of at least 2 blocks
    (True, 8, (512, 1)),  # one block of a 2-block tile: not the tile
    (True, 4, (32, 32)),  # a cluster of 32 blocks
    (True, 1, (256, 4)),  # P6's clusters of 4 and 16 left the library
    (True, 8, (64, 16)),
    (False, 4, (64, 1)),  # P5 is built for blocks of one warp
    (False, 3, (32, 1)),  # P is 1, 2, 4 or 8
])
def test_interleave_refuses_shape(any_in_index, P, shape):
    nodes, rays = _interleave_inputs(P)
    packed = tp5.pack_rays(P, [torch.as_tensor(r) for r in rays])
    with pytest.raises(ValueError):
        tp5.launch(torch.as_tensor(nodes), packed, 4, any_in_index, shape)
    if P not in tp5.PS:
        with pytest.raises(ValueError):
            tp5.launch(torch.as_tensor(nodes), packed, 4, any_in_index)


@pytest.mark.parametrize("P", tp2.PS)
def test_interleave2_shape_rule(monkeypatch, P):
    """P2 has one shape at every P: one cluster of 2-16 blocks (16 is the
    largest cluster the card takes) whose warps cover the 1,024 tile
    elements once; `launch` hands the C export that geometry."""
    from dpt_tpu_torch import probes
    from dpt_tpu_torch.kernels import build

    T, S = tp2.SHAPE
    assert T % 32 == 0 and T * tp2.BLOCKS == tp2.TILE
    assert 2 <= S <= 16 and S == tp2.BLOCKS
    geometry = []

    class Library:
        def dpt_probe_interleave2(self, *args):
            geometry.append(args[6:9])  # threads, cluster, blocks
            return 0

    monkeypatch.setattr(build, "load_probe_library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setitem(probes.launch_counts, "interleave2", 0)
    nodes, tris, rays = _interleave2_inputs(P)
    packed = tp5.pack_rays(P, [torch.as_tensor(r) for r in rays])
    tp2.launch(torch.as_tensor(nodes), torch.as_tensor(tris), packed, "B", 4)
    assert geometry == [(T, S, tp2.BLOCKS)]
    assert probes.launch_counts["interleave2"] == 1


@pytest.fixture
def no_probe_library(monkeypatch):
    """Fail the test if it loads (and so builds) the probe library."""
    from dpt_tpu_torch.kernels import build

    def refuse():
        raise AssertionError("the probe library was loaded")

    monkeypatch.setattr(build, "load_probe_library", refuse)


@pytest.mark.parametrize("P, variant", [
    (2, "A"), (4, "D"), (3, "B"),  # P is 1 or 8
    (1, "E"), (8, "a"), (1, None),  # variants A-D
])
def test_interleave2_launch_refuses_before_build(no_probe_library, P,
                                                 variant):
    nodes, tris, rays = _interleave2_inputs(P)
    packed = tp5.pack_rays(P, [torch.as_tensor(r) for r in rays])
    with pytest.raises(ValueError):
        tp2.launch(torch.as_tensor(nodes), torch.as_tensor(tris), packed,
                   variant, 4)


# A cuobjdump -sass listing in its layout: a P5 kernel with a set-up loop
# (one load) and its step loop (two loads, branch to a label), a P2 kernel
# whose step loop branches to an address under a predicate, and one
# kernel whose only branch goes forward.
_SASS = """
        Function : _Z17interleave_kernelILi8ELb0EEvPKfS1_iiPfPi
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   IADD3 R4, R4, 0x4, RZ ;
        /*0030*/               @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0040*/                   LDG.E.128 R8, desc[UR4][R6.64] ;
        /*0050*/                   LDG.E R3, desc[UR4][R6.64+0x30] ;
        /*0060*/                   FADD R5, R8, R2 ;
        /*0070*/                   F2I.TRUNC.NTZ R7, R3 ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
        /*0090*/                   EXIT ;
        ..........
        Function : _Z18interleave2_kernelILi8ELi3EEvPKfS1_S1_iPfPiS2_
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   MUFU.RCP R3, R2 ;
        /*0030*/                   CALL.REL.NOINC 0x90 ;
        /*0040*/               @!P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
        ..........
        Function : _Z18interleave2_kernelILi1ELi0EEvPKfS1_S1_iPfPiS2_
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0010*/                   BRA 0x30 ;
        /*0020*/                   NOP ;
        /*0030*/                   EXIT ;
        ..........
        Function : _ZN12_GLOBAL__N_116smem_walk_kernelILi1024ELi4EEEvPKfS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_10:
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   FMNMX R8, R4, R5, PT ;
.L_x_11:
        /*0030*/                   LDG.E.128.CONSTANT R12, desc[UR4][R10.64] ;
        /*0040*/                   LDG.E.128.CONSTANT R16, desc[UR4][R10.64+0x10] ;
        /*0050*/                   MUFU.RCP R20, R12 ;
        /*0060*/                   FFMA R21, -R12, R20, 1 ;
        /*0070*/                   FFMA R20, R20, R21, R20 ;
        /*0080*/               @P0 BRA `(.L_x_11) ;
        /*0090*/                   VOTE.ANY R22, PT, P1 ;
.L_x_12:
        /*00a0*/                   LDG.E.128.CONSTANT R12, desc[UR4][R10.64] ;
        /*00b0*/                   LDG.E.128.CONSTANT R16, desc[UR4][R10.64+0x10] ;
        /*00c0*/                   MUFU.RCP R20, R12 ;
        /*00d0*/                   BSSY B0, `(.L_x_13) ;
        /*00e0*/                   CALL.REL.NOINC `(.L_x_20) ;
.L_x_13:
        /*00f0*/                   BSYNC B0 ;
        /*0100*/                   FFMA R21, -R12, R20, 1 ;
        /*0110*/               @P2 BRA `(.L_x_12) ;
        /*0120*/               @P3 BRA `(.L_x_10) ;
        /*0130*/                   EXIT ;
"""


@pytest.mark.parametrize("kernel, innermost, want", [
    (r"interleave_kernelILi(\d+)ELb0E", False,
     [("8",), ["LDG", "LDG", "FADD", "F2I", "BRA"]]),
    (r"interleave2_kernelILi(\d+)ELi(\d+)E", False,
     [("8", "3"), ["LDG", "MUFU", "CALL", "BRA"]]),
    (r"interleave_kernelILi(\d+)ELb1E", False, None),  # no such function
    # P1: the walk loop holds the rare redo's CALL; its leaf loop does not
    (r"smem_walk_kernelILi(\d+)ELi(\d+)E", True,
     [("1024", "4"), ["LDG", "LDG", "MUFU", "FFMA", "FFMA", "BRA"]]),
    (r"smem_walk_kernelILi(\d+)ELi(\d+)E", False,
     [("1024", "4"), ["LDG", "FMNMX", "LDG", "LDG", "MUFU", "FFMA", "FFMA",
                      "BRA", "VOTE", "LDG", "LDG", "MUFU", "BSSY", "CALL",
                      "BSYNC", "FFMA", "BRA", "BRA"]]),
])
def test_sass_step_loop(kernel, innermost, want):
    """The step loop is the backward branch over the most loads (a label
    or an address as its target, a predicate before it); a function with
    no backward branch over a load has none.  The leaf loop (`innermost`)
    is the shortest of the loops with no loop inside over the most loads:
    P1's has no CALL."""
    from dpt_tpu_torch.probes import sass

    found = [(m.groups(), [o.split(".")[0] for o in ops])
             for m, ops in sass.step_loops(_SASS, kernel, innermost)]
    assert found == ([] if want is None else [tuple(want)])
    if innermost:
        assert "CALL" not in found[0][1]
    assert sass.opcode("@!P0 BRA 0x10") == "BRA"
    assert sass.opcode("F2I.TRUNC.NTZ R7, R3") == "F2I.TRUNC.NTZ"


# P4-b's kernel in the listing's layout: a fill loop of global loads and
# shared stores, then its step loop of shared loads alone.
_SASS_LDS = """
        Function : _ZN12_GLOBAL__N_112lanes_kernelILi4EEEvPKfPKiiPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
.L_x_0:
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR4][R4.64] ;
        /*0010*/                   STS.128 [R6], R8 ;
        /*0020*/               @P0 BRA `(.L_x_0) ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_1:
        /*0040*/                   IADD3 R3, R0, UR4, RZ ;
        /*0050*/                   LDS R12, [R3] ;
        /*0060*/                   LDS R13, [R3+0x4000] ;
        /*0070*/                   FADD R14, R14, R12 ;
        /*0080*/                   FADD R14, R14, R13 ;
        /*0090*/               @P1 BRA `(.L_x_1) ;
        /*00a0*/                   EXIT ;
"""


def test_sass_step_loop_by_shared_loads():
    """Asked for shared loads, the step loop is the backward branch over
    the most LDS (P4's lookups, whose tables a loop of global loads and
    shared stores fills first); asked for global loads (the default), the
    fill loop is taken."""
    from dpt_tpu_torch.probes import sass

    kernel = r"lanes_kernelILi(\d+)E"
    found = [(m.groups(), [o.split(".")[0] for o in ops])
             for m, ops in sass.step_loops(_SASS_LDS, kernel,
                                           loads=("LDS",))]
    assert found == [(("4",), ["IADD3", "LDS", "LDS", "FADD", "FADD",
                               "BRA"])]
    found = [ops for _, ops in sass.step_loops(_SASS_LDS, kernel)]
    assert found == [["LDG.E.CONSTANT", "STS.128", "BRA"]]


def _mt8_ok(trow, o, d):
    """Count of the probe's Möller–Trumbore tests of the tile rays against
    the 8 slots of one leaf row that are ok, in float32 numpy, in the
    probe's order of operations."""
    ox, oy, oz = o
    dx, dy, dz = d
    n = 0
    for f in trow:
        e1x, e1y, e1z, e2x, e2y, e2z = f[3:9]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = np.float32(1) / np.where(np.abs(det) < np.float32(1e-6),
                                       np.float32(1), det)
        tx, ty, tz = ox - f[0], oy - f[1], oz - f[2]
        u = inv * (tx * px + ty * py + tz * pz)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = inv * (dx * qx + dy * qy + dz * qz)
        t = inv * (e2x * qx + e2y * qy + e2z * qz)
        n += int(((u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                  & (t > np.float32(1e-6))).sum())
    return n


def _chain_sink(nodes, tris, rays, variant):
    """The sink of each chain (final sp, top of the stack, mt8 ok count) by
    a scalar loop over one chain's steps in float32 numpy: the stack logic
    spelled out one chain at a time."""
    table = nodes.reshape(-1, 16)
    trows = tris.reshape(-1, 8, 16)
    P = len(rays) // 6
    out = []
    for p in range(P):
        o = [rays[6 * p + k].reshape(-1) for k in range(3)]
        d = [rays[6 * p + 3 + k].reshape(-1) for k in range(3)]
        inv = [np.float32(1) / np.where(np.abs(x) < 1e-20, np.float32(1e-20),
                                        x) for x in d]
        stack = [0] * 32
        stack[0] = 7 * p + 1
        sp, n_ok = 1, 0
        with np.errstate(all="ignore"):
            for _ in range(ITERS):
                spm = max(sp - 1, 0)
                rid = stack[0 if variant == "A" else spm]
                rec = table[rid]

                def box(b):
                    tn = np.full_like(o[0], -np.inf)
                    tf = np.full_like(o[0], np.inf)
                    for k in range(3):
                        t0 = (rec[b + k] - o[k]) * inv[k]
                        t1 = (rec[b + 3 + k] - o[k]) * inv[k]
                        tn = np.maximum(tn, np.minimum(t0, t1))
                        tf = np.minimum(tf, np.maximum(t0, t1))
                    return bool(((tn <= tf) & (tf >= 0)).any())

                lhit, rhit = box(0), box(6)
                lptr = (int(rec[12]) + rid) % tp2.N_RECORDS
                rptr = (int(rec[13]) + rid) % tp2.N_RECORDS
                if variant == "A":
                    stack[0] = lptr if lhit else rptr
                    continue
                if variant == "D" or (variant == "C" and rec[14] > 0
                                      and lhit):
                    n_ok += _mt8_ok(trows[rid % 512], o, d)
                if lhit and rhit:
                    stack[spm], stack[spm + 1] = lptr, rptr
                elif lhit or rhit:
                    stack[spm] = lptr if lhit else rptr
                sp = max(min(spm + lhit + rhit, 30), 1)
        top = stack[0 if variant == "A" else max(sp - 1, 0)]
        out.append((sp, top, n_ok))
    return np.array(out)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("variant", tp2.VARIANTS)
def test_interleave2_matches_jax(jax_probe, variant, P):
    script = "scripts/attic/probe_interleave2.py"
    nodes, tris, *rays = _INPUTS[script]()
    rays = rays[:6 * P]
    want = jax_probe(script, variant)[:P]
    tiles, sink = tp2.make(P, variant, iters=ITERS)(
        torch.as_tensor(nodes), torch.as_tensor(tris),
        *map(torch.as_tensor, rays))
    assert len(want) == len(tiles) == P
    for w, got in zip(want, tiles):
        if variant == "A":
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)
        else:
            # B never adds to its accumulator; C and D take t only where
            # t < acc and t > 1e-6, which cannot happen from acc = 0.
            assert not np.any(w) and not got.any()
    np.testing.assert_array_equal(sink.numpy(),
                                  _chain_sink(nodes, tris, rays, variant))
    if variant in ("C", "D"):
        # mt8 ran and found ok slots (C's branch may skip a chain)
        assert sink[:, 2].sum() > 0


def _primary_rays():
    """The port's 16² primary stream of the default camera."""
    from dpt_tpu_torch import OrbitCamera, RenderConfig
    from dpt_tpu_torch.render.raygen import generate_rays

    o, d, _ = generate_rays(OrbitCamera().camera("cpu"),
                            RenderConfig(width=16, height=16), 0)
    return o, d


@pytest.fixture(scope="module")
def port_tables():
    """The port's tables of the 400-triangle procedural scene (SAH leaf
    8), which are the JAX package's byte for byte (test_torch_quad.py)."""
    from dpt_tpu_torch import RenderConfig, procedural_scene
    from dpt_tpu_torch.accel.bvh import build_accel

    cfg = RenderConfig(traversal="quad", bvh_builder="sah", bvh_leaf_size=8)
    return build_accel(procedural_scene(n_tris_target=400, device="cpu"),
                       cfg)


@pytest.fixture(scope="module")
def jax_tables():
    """The same scene's tables built by the JAX package, and carried into
    the port."""
    pytest.importorskip("jax")
    import dpt_tpu
    from dpt_tpu.accel.bvh import build_accel

    from dpt_tpu_torch.utils.convert import quad_accel_from_arrays

    cfg = dpt_tpu.RenderConfig(width=16, height=16, traversal="quad",
                               bvh_builder="sah", bvh_leaf_size=8,
                               packet_tile=256, interleave=1)
    accel = build_accel(dpt_tpu.procedural_scene(n_tris_target=400), cfg)
    port = quad_accel_from_arrays(np.asarray(accel.nodes_flat),
                                  np.asarray(accel.tris), accel.n_wide,
                                  accel.max_depth, device="cpu")
    return accel, cfg, port


def test_smem_walk_matches_jax(jax_tables):
    jax_accel, cfg, port = jax_tables
    ot, od = _primary_rays()
    jp1 = _script("scripts/r3_smem_proto.py")
    jt, jtri = jp1.smem_nearest(ot.numpy(), od.numpy(),
                                np.asarray(jax_accel.nodes).reshape(-1),
                                jax_accel.tris, cfg.packet_tile,
                                cfg.bvh_stack_depth)
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    # no equal-t ties on this stream (the TPU probe's tile octant and the
    # port's per-ray octant may break a tie apart): a brute-force test of
    # every slot finds one nearest triangle per hit ray
    slots = port.tris.reshape(1, -1, 16)
    bh, bt, _ = _leaf_tests(ot, od, slots)
    bt = torch.where(bh, bt, torch.full_like(bt, float("inf")))
    nearest = bt.min(dim=1, keepdim=True).values
    hit = torch.isfinite(nearest[:, 0])
    assert int(hit.sum()) >= 20
    assert ((bt == nearest) & hit[:, None]).sum(dim=1).le(1).all()
    for n_staged in tp1.staged_prefixes(port):
        t, tri = tp1.smem_nearest(ot, od, port, n_staged)
        np.testing.assert_allclose(t.numpy(), np.minimum(jt, tp1.T_MAX),
                                   rtol=1e-6)
        np.testing.assert_array_equal(t.numpy() < tp1.T_MAX, hit.numpy())
        np.testing.assert_array_equal(tri.numpy(), jtri)


def _bfs_levels(port):
    """Levels by a plain breadth-first walk over each record's children."""
    rec = port.nodes_flat.reshape(-1, 32).numpy()
    levels, frontier = [], [0]
    while frontier:
        levels.append(frontier)
        frontier = [int(rec[r, 24 + s]) for r in frontier for s in range(4)
                    if not np.isnan(rec[r, 6 * s]) and rec[r, 24 + s] >= 0]
    return levels


def test_level_starts(port_tables):
    port = port_tables
    starts = tp1.level_starts(port)
    levels = _bfs_levels(port)
    assert len(starts) == len(levels) + 1
    assert starts[-1] == port.n_wide
    for k, lev in enumerate(levels):
        assert lev == list(range(starts[k], starts[k + 1]))
    rec = port.nodes_flat.reshape(-1, 32).numpy()
    for k in range(len(levels) - 1):
        # every record above level k's end points only below level k+1's
        sub = rec[:starts[k + 1]]
        live = ~np.isnan(sub[:, 0:24:6]) & (sub[:, 24:28] >= 0)
        assert (sub[:, 24:28][live] < starts[k + 2]).all()
    prefixes = tp1.staged_prefixes(port)
    assert prefixes == [0] + starts[1:] and prefixes[-1] == port.n_wide
    with pytest.raises(ValueError):
        tp1.smem_nearest(torch.zeros(1, 3), torch.ones(1, 3), port,
                         port.n_wide + 1)
    with pytest.raises(ValueError):
        tp1.smem_nearest(torch.zeros(1, 3), torch.ones(1, 3), port, 0, 256)


def test_level_starts_refuse_other_orders(port_tables):
    """A table whose records are not in level order is refused: the root's
    first two child pointers swapped."""
    import dataclasses

    port = port_tables
    rec = port.nodes_flat.reshape(-1, 32).clone()
    assert (rec[0, 24:26] >= 0).all()
    rec[0, 24:26] = rec[0, 24:26].flip(0)
    bad = dataclasses.replace(port, nodes_flat=rec.reshape(-1))
    with pytest.raises(ValueError):
        tp1.level_starts(bad)


@pytest.fixture(scope="module")
def slow_reciprocal_scene():
    """The 400-triangle scene with one huge triangle planted in the plane
    x = X just past it (edges 1.5e19 along y and z), and 4,097 rays from
    origins 0.05-3 before that plane.  A ray with |dx| >= 0.38 meets it at
    |det| >= 2^126, where 1 / det is subnormal: P1's fast reciprocal (FTZ)
    gives 0 there, so u = v = t = 0 and the slot misses, and only the
    warp vote's redo with the IEEE 1.0f / x finds the hit.  Returns (accel,
    origin, direction, the huge triangle's id, X, [R] bool: the rays whose
    nearest hit is the huge triangle at a finite |det| >= 2^126)."""
    from dpt_tpu_torch import procedural_scene
    from dpt_tpu_torch.accel.bvh import build_bvh_sah, host_bvh
    from dpt_tpu_torch.kernels.quad import pack_quad

    sc = procedural_scene(n_tris_target=400, device="cpu")
    v, idx = sc.vertices.numpy(), sc.indices.numpy()
    X = np.float32(v[:, 0].max() + 0.25)
    E, H = np.float32(1.5e19), np.float32(7e18)
    huge = np.array([[X, -H, -H], [X, E - H, -H], [X, -H, E - H]],
                    np.float32)
    V = np.concatenate([v, huge])
    I = np.concatenate([idx, [[len(v), len(v) + 1, len(v) + 2]]]).astype(
        np.int32)
    accel = pack_quad(host_bvh(build_bvh_sah(V, I, leaf_size=8)),
                      V[I[:, 0]], V[I[:, 1]], V[I[:, 2]], device="cpu")
    rng = np.random.default_rng(5)
    o = rng.normal(size=(4097, 3)).astype(np.float32)
    o[:, 0] = X - rng.uniform(0.05, 3.0, size=4097).astype(np.float32)
    d = rng.normal(size=(4097, 3)).astype(np.float32)
    # det of the huge slot in K1's order (slot_test), float32
    e1, e2 = huge[1] - huge[0], huge[2] - huge[0]
    with np.errstate(over="ignore"):
        p = np.stack([d[:, 1] * e2[2] - d[:, 2] * e2[1],
                      d[:, 2] * e2[0] - d[:, 0] * e2[2],
                      d[:, 0] * e2[1] - d[:, 1] * e2[0]], axis=1)
        det = e1[0] * p[:, 0] + e1[1] * p[:, 1] + e1[2] * p[:, 2]
    ot, od = torch.as_tensor(o), torch.as_tensor(d)
    _, tri = tp1.smem_nearest_reference(ot, od, accel)
    slow_hit = ((tri.numpy() == len(I) - 1) & np.isfinite(det)
                & (np.abs(det) >= np.float32(2.0 ** 126)))
    return accel, ot, od, len(I) - 1, float(X), slow_hit


def test_smem_walk_slow_reciprocal_scene(slow_reciprocal_scene):
    """The planted scene exercises P1's IEEE redo: many rays' nearest hit
    is the huge triangle at |det| >= 2^126, in warps (32 rays in order)
    whose other lanes do not need it; the plain walk finds those hits at
    the plane's distance (float64), so its subnormal 1 / det is kept."""
    accel, o, d, huge, X, slow_hit = slow_reciprocal_scene
    assert slow_hit.sum() >= 200
    warps = slow_hit[:4096].reshape(-1, 32)
    assert (warps.any(axis=1) & ~warps.all(axis=1)).sum() >= 64
    t, tri = tp1.smem_nearest(o, d, accel, accel.n_wide)
    o64, d64 = o.double().numpy(), d.double().numpy()
    want = (X - o64[slow_hit, 0]) / d64[slow_hit, 0]
    np.testing.assert_allclose(t.numpy()[slow_hit], want, rtol=1e-5)
    assert (tri.numpy()[slow_hit] == huge).all()


# The flagship's level starts (65,024 triangles, SAH leaf 8: 5,574
# records), as r3_smem_proto prints them on the card.
FLAGSHIP_LEVEL_STARTS = [0, 1, 5, 21, 85, 341, 1365, 4684, 5508, 5570,
                         5574]


def _layout(n_staged, cluster=None, n_rep=None):
    """Each block's records in slot order, by `home`, for a plan (or a
    forced cluster / replication); checks that every record lands once
    (the replicated prefix once in every block, at its id), that slots run
    from 0 without a gap, and that each block fits its shared memory."""
    _, cluster, n_rep = tp1.shape(n_staged, None, cluster, n_rep)
    held = [{} for _ in range(cluster)]
    for rec in range(n_staged):
        blk, slot = tp1.home(rec, n_rep, cluster)
        for b in range(cluster) if blk is None else [blk]:
            assert slot not in held[b]
            held[b][slot] = rec
    for b, slots in enumerate(held):
        assert sorted(slots) == list(range(len(slots)))
        assert len(slots) == tp1.block_count(n_staged, n_rep, cluster, b)
        assert [slots[k] for k in range(n_rep)] == list(range(n_rep))
        assert (len(slots) * tp1.RECORD_BYTES + tp1.BARRIER_BYTES
                <= tp1.MAX_SHARED_BYTES == 232_448)
    owned = sorted(r for slots in held for k, r in slots.items()
                   if k >= n_rep)
    assert owned == list(range(n_rep, n_staged))
    return cluster, n_rep


def test_smem_layout(port_tables):
    """The record -> (block, slot) layout: the test scene's prefixes in
    one block; the flagship's level ends (given as numbers, not built) in
    one block up to levels 0-5, the rest and the whole table over 4 blocks
    with levels 0-4 in each (211 KB a block); forced clusters of 2, 4, 8;
    the largest table 8 blocks hold, and one record more refused."""
    for n in tp1.staged_prefixes(port_tables):
        assert _layout(n) == (1, n)
    B = tp1.BLOCK_RECORDS
    assert B == 1815
    for n in FLAGSHIP_LEVEL_STARTS[1:]:
        assert _layout(n) == ((1, n) if n <= 1365 else (4, 341))
    assert tp1.block_count(5574, 341, 4) == 1650  # 211,208 B with the barrier
    for n, cluster in ((3000, 2), (5574, 4), (5574, 8)):
        for n_rep in (0, 1, 341):
            assert _layout(n, cluster, n_rep) == (cluster, n_rep)
    assert _layout(2 * B) == (2, 0)
    assert _layout(8 * B) == (8, 0)
    with pytest.raises(ValueError):
        tp1.plan(8 * B + 1)
    for bad in (dict(block=128, cluster=4), dict(cluster=2),
                dict(cluster=3), dict(cluster=16), dict(block=512),
                dict(cluster=4, n_rep=5575), dict(cluster=2, n_rep=0)):
        with pytest.raises(ValueError):
            tp1.shape(5574, **bad)
    with pytest.raises(ValueError):
        tp1.shape(10, cluster=1, n_rep=5)
    assert tp1.shape(5574) == (1024, 4, 341)
    assert tp1.shape(85) == (128, 1, 85)
    assert tp1.grid(126_621, 1024, 4) == 124
    assert tp1.grid(4097, 1024, 4) == 8
    modes = tp1.modes(port_tables)
    assert modes == [(n, b) for n in tp1.staged_prefixes(port_tables)
                     for b in tp1.BLOCKS]


# --- on the card: each kernel against its plain version, bit for bit ---


@pytest.mark.cuda
@pytest.mark.parametrize("P", tp5.PS)
@pytest.mark.parametrize("probe", sorted(INTERLEAVE))
def test_interleave_kernel_exact(cuda, probe, P):
    port = INTERLEAVE[probe][1]
    nodes, rays = _interleave_inputs(P)
    args = [torch.as_tensor(x, device=cuda) for x in (nodes, *rays)]
    tiles, sink = port.make(P, iters=64)(*args)
    ref = tp5.interleave_reference(args[0], tp5.pack_rays(P, args[1:]), 64,
                                   probe == "P6")
    assert torch.equal(torch.stack(tiles).reshape(P, -1), ref[0])
    assert torch.equal(sink, ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("P", tp5.PS)
@pytest.mark.parametrize("any_in_index", [False, True])
def test_interleave_shape_exact(cuda, any_in_index, P):
    """The shape the library takes equals the plain version bit for bit
    at every P, with each block on an SM of the card."""
    nodes, rays = _interleave_inputs(P, seed=3)
    n = torch.as_tensor(nodes, device=cuda)
    packed = tp5.pack_rays(P, [torch.as_tensor(r, device=cuda)
                               for r in rays])
    shape = tp5.SHAPE[any_in_index]
    sm = torch.full((tp5.blocks(shape),), -1, dtype=torch.int32, device=cuda)
    acc, sink = tp5.launch(n, packed, 64, any_in_index, shape, sm)
    ref = tp5.interleave_reference(n, packed, 64, any_in_index)
    assert torch.equal(acc, ref[0]) and torch.equal(sink, ref[1])
    props = torch.cuda.get_device_properties(cuda)
    assert bool(((sm >= 0) & (sm < props.multi_processor_count)).all())


@pytest.mark.cuda
def test_interleave_c_side_refuses_grid(cuda):
    """The C launch refuses a grid that does not cover the tile once and a
    cluster that is not the whole grid: cudaErrorInvalidValue (1)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    nodes, rays = _interleave_inputs(1)
    n = torch.as_tensor(nodes, device=cuda)
    packed = tp5.pack_rays(1, [torch.as_tensor(r, device=cuda)
                               for r in rays])
    out = torch.empty((1, tp5.TILE), device=cuda)
    sink = torch.empty((1, 3), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for any_in_index, threads, cluster, blocks in (
            (0, 32, 1, 31), (0, 32, 2, 32), (1, 128, 4, 8),
            (1, 128, 8, 16), (0, 1024, 1, 1), (1, 1024, 1, 1),
            (1, 256, 4, 4), (1, 64, 16, 16), (0, 64, 1, 16)):
        err = lib.dpt_probe_interleave(
            n.data_ptr(), packed.data_ptr(), 1, 4, any_in_index, threads,
            cluster, blocks, out.data_ptr(), sink.data_ptr(), None, stream)
        assert err == 1, (any_in_index, threads, cluster, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("P", tp2.PS)
@pytest.mark.parametrize("variant", tp2.VARIANTS)
def test_interleave2_kernel_exact(cuda, variant, P, seed):
    """P2's cluster kernel equals the plain version bit for bit (tiles and
    sink), through `make` and through `launch` reading each block's SM,
    which must be an SM of the card."""
    nodes, tris, rays = _interleave2_inputs(P, seed)
    args = [torch.as_tensor(x, device=cuda) for x in (nodes, tris, *rays)]
    tiles, sink = tp2.make(P, variant, iters=64)(*args)
    packed = tp5.pack_rays(P, args[2:])
    ref = tp2.interleave2_reference(args[0], args[1], packed, variant, 64)
    assert torch.equal(torch.stack(tiles).reshape(P, -1), ref[0])
    assert torch.equal(sink, ref[1])
    sm = torch.full((tp2.BLOCKS,), -1, dtype=torch.int32, device=cuda)
    acc, sink = tp2.launch(args[0], args[1], packed, variant, 64, sm)
    assert torch.equal(acc, ref[0]) and torch.equal(sink, ref[1])
    props = torch.cuda.get_device_properties(cuda)
    assert bool(((sm >= 0) & (sm < props.multi_processor_count)).all())


@pytest.mark.cuda
def test_interleave2_c_side_refuses_grid(cuda):
    """The C launch refuses a P, variant or shape it is not built for and a
    grid that does not cover the tile once in one cluster:
    cudaErrorInvalidValue (1)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    nodes, tris, rays = _interleave2_inputs(1)
    n, t = (torch.as_tensor(x, device=cuda) for x in (nodes, tris))
    packed = tp5.pack_rays(1, [torch.as_tensor(r, device=cuda)
                               for r in rays])
    out = torch.empty((8, tp5.TILE), device=cuda)
    sink = torch.empty((8, 3), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    T, S = tp2.SHAPE
    for P, variant, threads, cluster, blocks in (
            (1, 0, T, S, S - 1), (1, 1, T, S // 2, S), (8, 3, T, S, 2 * S),
            (1, 0, 1024, 1, 1), (2, 0, T, S, S), (1, 4, T, S, S),
            (8, 1, 256, 4, 4), (1, 2, 32, 32, 32), (8, 0, 2 * T, S, S),
            (8, 3, 64, 16, 16)):
        err = lib.dpt_probe_interleave2(
            n.data_ptr(), t.data_ptr(), packed.data_ptr(), P, variant, 4,
            threads, cluster, blocks, out.data_ptr(), sink.data_ptr(), None,
            stream)
        assert err == 1, (P, variant, threads, cluster, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster, n_rep", [
    (None, None), (2, 0), (2, 1), (4, 5), (8, 0), (8, 21)])
def test_smem_walk_kernel_exact(cuda, port_tables, cluster, n_rep):
    """P1 equals the plain walk bit for bit in every mode (through
    `smem_nearest`), and in forced cluster sizes and replications at every
    prefix (through `launch`), on 16² rays and on 4,097 rays, which leave
    the last cluster's last block mostly past n_rays."""
    acc = port_tables.to(cuda)
    ot, od = (x.to(cuda) for x in _primary_rays())
    rng = np.random.default_rng(3)
    streams = [(ot, od), tuple(torch.as_tensor(
        rng.normal(size=(4097, 3)).astype(np.float32), device=cuda)
        for _ in range(2))]
    for o, d in streams:
        pt, pi = tp1.smem_nearest_reference(o, d, acc)
        if cluster is None:
            runs = [tp1.smem_nearest(o, d, acc, s, b)
                    for s, b in tp1.modes(acc)]
        else:
            runs = [tp1.launch(o, d, acc, s, None, cluster,
                               min(n_rep, s))
                    for s in tp1.staged_prefixes(acc)]
        torch.cuda.synchronize()
        for t, tri in runs:
            assert torch.equal(t, pt) and torch.equal(tri, pi)


@pytest.mark.cuda
def test_smem_walk_slow_reciprocal_exact(cuda, slow_reciprocal_scene):
    """P1's IEEE redo: on the planted scene, where the fast reciprocal
    alone would miss the huge triangle on the rays of `slow_hit`, P1 in
    every mode and in forced clusters of 2, 4 and 8 equals the plain walk
    and K1 lane bit for bit."""
    from dpt_tpu_torch.kernels import quad

    accel, o, d, huge, _, slow_hit = slow_reciprocal_scene
    acc, o, d = accel.to(cuda), o.to(cuda), d.to(cuda)
    pt, pi = tp1.smem_nearest_reference(o, d, acc)
    kt, ki = quad._launch(o, d, None, acc, False, "lane")
    assert torch.equal(pi.cpu()[torch.as_tensor(slow_hit)],
                       torch.full((int(slow_hit.sum()),), huge,
                                  dtype=torch.int32))
    runs = [tp1.smem_nearest(o, d, acc, s, b) for s, b in tp1.modes(acc)]
    runs += [tp1.launch(o, d, acc, s, None, cluster, min(n_rep, s))
             for cluster, n_rep in ((2, 0), (4, 5), (8, 1))
             for s in tp1.staged_prefixes(acc)]
    torch.cuda.synchronize()
    assert torch.equal(kt, pt) and torch.equal(ki, pi)
    for t, tri in runs:
        assert torch.equal(t, pt) and torch.equal(tri, pi)


@pytest.mark.cuda
def test_smem_walk_rcp_exhaustive(cuda):
    """The leaf test's reciprocal equals 1.0f / x on every float32 of its
    input range (|x| >= 1e-6, both signs, inf and NaN)."""
    rcp = tp1.rcp_check(cuda)
    assert rcp["tested"] == rcp["expected"] > 2 ** 31
    assert rcp["differing"] == 0
    assert 0 < rcp["fast"] < rcp["tested"]


@pytest.mark.cuda
def test_smem_walk_c_side_refuses(cuda, port_tables):
    """The C launch refuses a grid that does not cover each ray once in
    whole clusters, a shape it is not built for ((1, 1271) and (129, -9)
    included), a split it cannot hold and a table beyond 8 blocks:
    cudaErrorInvalidValue (1)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    acc = port_tables.to(cuda)
    ot, od = (x.to(cuda) for x in _primary_rays())
    R = ot.shape[0]  # 256 rays
    out_t = torch.empty(R, device=cuda)
    out_i = torch.empty(R, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    B = tp1.BLOCK_RECORDS
    n = acc.n_wide
    for n_staged, n_rep, threads, cluster, blocks in (
            (0, 0, 128, 1, 1), (0, 0, 128, 1, 3), (n, n, 1024, 1, 2),
            (n, 0, 1024, 2, 1), (n, 0, 1024, 2, 4), (n, 0, 1024, 4, 2),
            (n, n, 256, 1, 1), (n, 0, 128, 2, 2), (n, 0, 1024, 16, 16),
            (n, 0, 1024, 3, 3), (n, 0, 1024, 1, 1), (n, n + 1, 1024, 2, 2),
            (8 * B + 1, 0, 1024, 8, 8), (2 * B + 2, 0, 1024, 2, 2),
            (B + 1, B + 1, 1024, 1, 1), (0, 0, 1, 1271, 1271),
            (0, 0, 129, -9, 0)):
        err = lib.dpt_quad_traverse_smem(
            ot.data_ptr(), od.data_ptr(), acc.nodes_flat.data_ptr(),
            acc.tris.data_ptr(), R, n_staged, n_rep, threads, cluster,
            blocks, out_t.data_ptr(), out_i.data_ptr(), stream)
        assert err == 1, (n_staged, n_rep, threads, cluster, blocks)
