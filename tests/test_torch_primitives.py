"""dpt_tpu_torch primitive probes ≡ the JAX probe scripts they port.

  - P3 (`probe_gather`): the lane and row gathers against `kern` and
    `kern0` of scripts/attic/probe_gather.py at their own 1000 and 100
    steps; `xla_gather` and `chase` against the script's jnp indexing;
    P3-a's plain version against P4-b's at K = 1 (whose kernel it
    launches) and a model of P3-b's column copies on the CPU.
  - P4 (`probe_crossbar`): the five kernels of scripts/probe_crossbar.py
    (B at K = 1, 4, 12) with ITERS = 16; E allclose at rtol 1e-6 (XLA
    contracts its multiply-add chain into fused multiply-adds, the port
    rounds each operation), the others bit-equal; E's chain latency bound
    and the share taken against the larger bound, and the plain version
    of the bare chain that reads the card's clocks an operation.
  - P7 (`probe_pallas`) and P8 (`probe_pallas2`): the eight Mosaic feature
    checks of scripts/attic/probe_pallas.py and probe_pallas2.py,
    bit-equal, at indices in range and out of it (JAX takes a negative
    index from the end and clamps the start, and so does the port).

Each kernel is compared on the script's own inputs (its jax.random arrays,
or its TABLE at i in {0, 127, 128, 200, 511}) and on seeded numpy ones.
The JAX kernels run on the CPU in interpret mode: a pallas_call that
records the kernel and its specs stands in for Pallas's while each script
builds its call, and the recorded kernel is replayed under jax.jit with
interpret=True on the test's arrays.  scripts/probe_crossbar.py runs
everything when imported, so its kernels and `run_kernel` / `go_d` are
taken from its syntax tree and run with ITERS = 16.  Tests marked `cuda`
compare each CUDA kernel with its plain version on the card, bit for bit;
they skip without one.
"""

import ast
import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.probes import probe_crossbar as tp4
from dpt_tpu_torch.probes import probe_gather as tp3
from dpt_tpu_torch.probes import probe_pallas as tp7
from dpt_tpu_torch.probes import probe_pallas2 as tp8

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITERS = 16  # P4's steps here (its script's ITERS is 2000)
P8_INDICES = [0, 127, 128, 200, 511, -1, -600, 600, 10**6]
P7_INDICES = [0, 3, 5, 7, -1, -9, 8, 10**6]


class _Recorded(Exception):
    """Raised by the recording pallas_call once it holds the kernel."""


def _script(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_" + pathlib.Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _crossbar_defs(ns):
    """scripts/probe_crossbar.py's kernels, `run_kernel` and `go_d`, taken
    from its syntax tree and defined in `ns` (the script's module body runs
    every probe at ITERS = 2000)."""
    path = ROOT / "scripts/probe_crossbar.py"
    wanted = {"run_kernel", "kern_a", "kern_b", "kern_c", "kern_d",
              "kern_e", "go_d"}
    defs = [n for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert sorted(d.name for d in defs) == sorted(wanted)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


@pytest.fixture(scope="module")
def jax_kernels():
    """name -> f(*numpy arrays) -> numpy array: each JAX probe kernel,
    recorded from its script and replayed in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    real = pl.pallas_call
    recorded = []

    def record(kernel, **specs):
        recorded.append((kernel, specs))
        raise _Recorded

    def replay(kernel, specs):
        call = jax.jit(lambda *a: real(kernel, interpret=True, **specs)(*a))
        return lambda *arrays: np.asarray(call(*arrays))

    def take(fn, *args):
        n = len(recorded)
        with pytest.raises(_Recorded):
            fn(*args)
        assert len(recorded) == n + 1
        return replay(*recorded[-1])

    out = {}
    z = functools.partial(jnp.zeros, dtype=jnp.float32)
    zi = functools.partial(jnp.zeros, dtype=jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", record)
        p7 = _script("scripts/attic/probe_pallas.py")
        p8 = _script("scripts/attic/probe_pallas2.py")
        for mod in (p7, p8):
            for name in dir(mod):
                if name.startswith("probe_"):
                    out[name] = take(getattr(mod, name))
        n = len(recorded)
        # The P3 script draws its inputs before each call; the recording
        # needs none of them.  Each of its two timings catches the failure
        # and goes on.
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype: jnp.zeros(shape, dtype))
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi, dtype: jnp.zeros(shape, dtype))
        _script("scripts/attic/probe_gather.py").pallas_gather_probe()
        assert len(recorded) == n + 2
        out["kern"], out["kern0"] = (replay(*r) for r in recorded[n:])
        ns = _crossbar_defs({"jax": jax, "jnp": jnp, "pl": pl,
                             "pltpu": pltpu, "ITERS": ITERS, "K": 1})
        tile, itile = z((8, 128)), zi((8, 128))
        run = ns["run_kernel"]
        out["kern_a"] = take(run(ns["kern_a"], None, 2), tile, itile)
        for K in tp4.KS:
            out[f"kern_b{K}"] = take(
                run(functools.partial(ns["kern_b"], K=K), None, 2), tile,
                itile)
        out["kern_c"] = take(run(ns["kern_c"], None, 3), tile, itile, itile)
        out["kern_d"] = take(ns["go_d"], z((4096, 128)), zi((ITERS,)))
        out["kern_e"] = take(run(ns["kern_e"], None, 1), tile)
    return out


@pytest.fixture(scope="module")
def script_inputs():
    """The arrays the P3 and P4 scripts draw with jax.random, as numpy."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    @jax.jit  # one compile for all of them
    def draw():
        key = jax.random.PRNGKey(0)
        k1, k2, k3 = (jax.random.PRNGKey(s) for s in (1, 2, 3))
        return {
            "x": jax.random.normal(key, (8, 128), jnp.float32),
            "idx": jax.random.randint(k1, (8, 128), 0, 128, jnp.int32),
            "sub": jax.random.randint(k2, (8, 128), 0, 8, jnp.int32),
            "x0": jax.random.normal(key, (64, 128), jnp.float32),
            "idx0": jax.random.randint(k1, (64, 128), 0, 64, jnp.int32),
            "tab": jax.random.normal(key, (4096, 128), jnp.float32),
            "rows": jax.random.randint(k3, (2000,), 0, 511,
                                       jnp.int32)[:ITERS],
        }

    return {k: np.array(v) for k, v in draw().items()}


def _seeded_inputs(seed):
    """Seeded inputs of the same shapes, the indices beyond the scripts'
    ranges (negative and large: floor mod and JAX's clamped starts)."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(8, 128)).astype(np.float32),
        "idx": rng.integers(-1000, 1000, (8, 128), dtype=np.int32),
        "sub": rng.integers(-50, 50, (8, 128), dtype=np.int32),
        "x0": rng.normal(size=(64, 128)).astype(np.float32),
        "idx0": rng.integers(-500, 500, (64, 128), dtype=np.int32),
        "tab": rng.normal(size=(4096, 128)).astype(np.float32),
        "rows": np.concatenate([
            rng.integers(0, 511, ITERS - 4, dtype=np.int32),
            np.array([-1, -600, 600, 2**28], dtype=np.int32)]),
    }


@pytest.fixture(params=["script", "seeded"])
def inputs(request, script_inputs):
    if request.param == "script":
        return script_inputs
    return _seeded_inputs(7)


def _t(a):
    return torch.as_tensor(a)


# --- P3 ---


@pytest.mark.parametrize("axis", [1, 0])
def test_gather_matches_jax(jax_kernels, inputs, axis):
    if axis == 1:
        want = jax_kernels["kern"](inputs["x"], inputs["idx"])
        got = tp3.axis1_gather(_t(inputs["x"]), _t(inputs["idx"]))
    else:
        want = jax_kernels["kern0"](inputs["x0"], inputs["idx0"])
        got = tp3.axis0_gather(_t(inputs["x0"]), _t(inputs["idx0"]))
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_gather_matches_take():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    table = rng.normal(size=(1000, 16)).astype(np.float32)
    idx = rng.integers(0, 1000, 4096, dtype=np.int32)
    want = np.asarray(jnp.sum(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                                       axis=0), axis=-1))
    np.testing.assert_allclose(tp3.xla_gather(_t(table), _t(idx)).numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_chase_matches_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n = 512
    table = rng.integers(0, n, (n, 8), dtype=np.int32)
    idx = rng.integers(0, n, 2048, dtype=np.int32)

    def body(i, ix):  # the script's chase body
        return (jnp.asarray(table)[ix][:, 0] + i) % n

    want = np.asarray(jax.lax.fori_loop(0, tp3.CHASE_STEPS, body,
                                        jnp.asarray(idx)))
    got = tp3.chase(_t(table), _t(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --- P4 ---

CROSSBAR = {
    "a": ("kern_a", ("x", "sub"),
          lambda a: tp4.sublane_gather(a["x"], a["sub"], ITERS)),
    **{f"b{K}": (f"kern_b{K}", ("x", "idx"),
                 lambda a, K=K: tp4.lane_gathers(a["x"], a["idx"], K, ITERS))
       for K in tp4.KS},
    "c": ("kern_c", ("x", "idx", "sub"),
          lambda a: tp4.fused_lookup(a["x"], a["idx"], a["sub"], ITERS)),
    "d": ("kern_d", ("tab", "rows"),
          lambda a: tp4.row_blocks(a["tab"], a["rows"])),
    "e": ("kern_e", ("x",), lambda a: tp4.vector_ops(a["x"], ITERS)),
}


@pytest.mark.parametrize("kernel", sorted(CROSSBAR))
def test_crossbar_matches_jax(jax_kernels, inputs, kernel):
    name, args, port = CROSSBAR[kernel]
    want = jax_kernels[name](*(inputs[k] for k in args))
    got = port({k: _t(v) for k, v in inputs.items()}).numpy()
    assert np.abs(want).max() > 0
    if kernel == "e":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# D's ring in crossbar.cu (`test_ring_constants_match_crossbar_cu` holds
# them to it): G steps a stage on one mbarrier, S stages.
_ROWS_GROUP = 16  # kRowsGroup
_ROWS_STAGES = 8  # kRowsStages
G, S = _ROWS_GROUP, _ROWS_STAGES
# D's row counts about its ring: 1, a stage less and more one, and two
# passes over the ring's stages and one step.
RING_ROW_COUNTS = [1, G - 1, G + 1, 2 * S * G + 1]


def test_ring_constants_match_crossbar_cu():
    """The ring's stage and depth that the tests below assume are the
    ones crossbar.cu builds D with."""
    text = (pathlib.Path(tp4.__file__).resolve().parent.parent / "csrc"
            / "probes" / "crossbar.cu").read_text()
    for name, value in (("kRowsGroup", _ROWS_GROUP),
                        ("kRowsStages", _ROWS_STAGES),
                        ("kRowsThreads", 32)):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [
            str(value)], name


def _ring_rows(rng, n):
    """n rows drawn as the TPU script draws them, with a row that wraps (-1:
    the table's last block) and two that clamp (600, 511) at the first,
    middle and last step (the last written wins where they coincide)."""
    rows = rng.integers(0, tp4.ROW_BLOCKS, n, dtype=np.int32)
    for pos, v in zip((0, n // 2, n - 1), (-1, 600, 511)):
        if n:
            rows[pos] = v
    return rows


@pytest.fixture(scope="module")
def jax_row_blocks():
    """n -> f(tab, rows): scripts/probe_crossbar.py's `kern_d` through
    `go_d` at ITERS = n, recorded and replayed in interpret mode as
    `jax_kernels` does."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    real = pl.pallas_call
    made = {}

    def record(kernel, **specs):
        made["recorded"] = (kernel, specs)
        raise _Recorded

    def get(n):
        if n not in made:
            ns = _crossbar_defs({"jax": jax, "jnp": jnp, "pl": pl,
                                 "pltpu": pltpu, "ITERS": n, "K": 1})
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pl, "pallas_call", record)
                with pytest.raises(_Recorded):
                    ns["go_d"](jnp.zeros((tp4.TABLE_ROWS, tp4.LANES),
                                         jnp.float32),
                               jnp.zeros((n,), jnp.int32))
            kernel, specs = made.pop("recorded")
            call = jax.jit(lambda *a: real(kernel, interpret=True,
                                           **specs)(*a))
            made[n] = lambda *arrays: np.asarray(call(*arrays))
        return made[n]

    return get


@pytest.mark.parametrize("n", RING_ROW_COUNTS)
def test_row_blocks_match_jax_around_the_ring(jax_row_blocks, n):
    """P4-d at row counts off its stage of G steps and past two turns of
    its ring of S stages, with rows that wrap and clamp, equals the JAX
    probe's `kern_d` at ITERS = n bit for bit."""
    rng = np.random.default_rng(40 + n)
    tab = rng.normal(size=(tp4.TABLE_ROWS, tp4.LANES)).astype(np.float32)
    rows = _ring_rows(rng, n)
    want = jax_row_blocks(n)(tab, rows)
    got = tp4.row_blocks(_t(tab), _t(rows)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, *RING_ROW_COUNTS, S * G, 2003])
def test_rows_ring_schedule(n):
    """D's ring as crossbar.cu `rows_kernel` runs it: stage i (steps i G ..
    i G + G - 1, the last one short) is issued at turn i into slot i % S
    and consumed at turn i + S on phase i // S of that slot's mbarrier;
    a slot is refilled only at the turn that consumed it, so each stage is
    read whole, once, in the order of k, after it landed and before its
    slot is refilled; each turn's addresses lie in its chunk of S G,
    computed at the chunk's first turn from the rows read a chunk ahead;
    16 KB of ring for one-warp blocks."""
    stages = -(-n // G)
    turns = stages + S if stages else 0
    slots = [None] * S  # the stage each slot holds
    phases = [0] * S  # the phases each slot's mbarrier has completed
    read, starts_read = [], set()
    for j0 in range(0, turns, S):
        chunk = range(j0 * G, (j0 + S) * G)  # the steps of its starts
        for j in range(j0, min(j0 + S, turns)):
            slot = j % S
            if j >= S:
                i = j - S
                assert slots[slot] == i
                # parity (i // S) & 1: the phase i // S has completed
                assert phases[slot] == i // S + 1
                read.extend(range(i * G, min(n, i * G + G)))
                slots[slot] = None  # handed back
            if j < stages:
                assert slots[slot] is None
                steps = range(j * G, min(n, j * G + G))
                assert all(k in chunk for k in steps)
                assert (j - j0) * G + G <= S * G  # inside the chunk
                starts_read.update(steps)
                slots[slot] = j
                phases[slot] += 1
    assert read == list(range(n)) and starts_read == set(range(n))
    assert all(v is None for v in slots)
    assert S * G * 32 * 4 == 16 * 1024


@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
def test_sublane_layout_reads_its_own_bank(pattern):
    """A's layout as crossbar.cu `sublane_kernel` builds it: block b of 32
    threads copies its columns of x's 8 rows, lane l's word of row j at j *
    32 + l; step k reads row (sub + k) % 8 (a sum wrapping in int32), which
    for k = 8 g + u is the lane's offset u, so each lane reads only its own
    bank and a warp's 32 lanes 32 distinct banks at every step; the words
    summed equal the plain version."""
    rng = np.random.default_rng(32)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32))
    sub = torch.as_tensor(_lookup_tiles(rng, pattern)["srow"]).reshape(-1)
    e = torch.arange(tp4.ROWS * tp4.LANES)
    block, lane, col = e // 32, e % 32, e % tp4.LANES
    # each block's copy: [32 blocks, 8 rows x 32 lanes]
    copy = torch.stack([x[:, c0:c0 + 32].reshape(-1) for c0 in
                        (b % 4 * 32 for b in range(32))])
    offs = [torch.remainder(sub + u, tp4.ROWS).long() * 32 + lane
            for u in range(8)]
    acc = torch.zeros(tp4.ROWS * tp4.LANES)
    for k in range(20):
        off = offs[k % 8]
        assert torch.equal(off % BANKS, lane)
        row = torch.remainder(sub + k, tp4.ROWS).long()
        assert torch.equal(copy[block, off], x[row, col])
        acc = acc + copy[block, off]
    assert torch.equal(acc.reshape(tp4.ROWS, tp4.LANES),
                       tp4.sublane_gather_reference(
                           x, sub.reshape(tp4.ROWS, tp4.LANES), 20))


# P4-a's and P4-d's step loops in a cuobjdump -sass listing's layout: A's
# loop of a shared load and an add a step; D's loop over chunks (global
# loads of the next chunk's rows, shared stores of the addresses) around
# its step loop (an mbarrier wait that spins, the slices' shared loads, a
# bulk copy a step, the adds).
_SASS_P4 = """
        Function : _ZN12_GLOBAL__N_114sublane_kernelEPKfPKiiPf
.L_x_0:
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   FADD R0, R0, R5 ;
        /*0020*/                   LDS R5, [R2+0x80] ;
        /*0030*/                   FADD R0, R0, R4 ;
        /*0040*/               @P0 BRA `(.L_x_0) ;
        /*0050*/                   EXIT ;
        ..........
        Function : _ZN12_GLOBAL__N_111rows_kernelEPKfiPKiiPf
.L_x_10:
        /*0000*/                   LDG.E.CONSTANT R8, desc[UR4][R2.64] ;
        /*0010*/                   STS.64 [R6], R10 ;
        /*0020*/                   LDS.64 R12, [R6] ;
.L_x_11:
        /*0030*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR5], R3 ;
.L_x_12:
        /*0040*/              @!P0 BRA `(.L_x_12) ;
        /*0050*/                   LDS R20, [R4] ;
        /*0060*/                   LDS R21, [R4+0x80] ;
        /*0070*/                   UBLKCP.S.G [UR8], [UR10], UR7 ;
        /*0080*/                   UBLKCP.S.G [UR12], [UR14], UR7 ;
        /*0090*/                   LDS.64 R12, [R6+0x10] ;
        /*00a0*/                   FADD R0, R20, R0 ;
        /*00b0*/                   FADD R0, R21, R0 ;
        /*00c0*/               @P1 BRA `(.L_x_11) ;
        /*00d0*/               @P2 BRA `(.L_x_10) ;
        /*00e0*/                   EXIT ;
"""


def test_sass_counts_of_p4_step_loops():
    """`sass.loop_counts` finds A's step loop by its shared loads (2
    instructions and 1 LDS a step) and D's by its adds: the inner loop,
    with no global load and a bulk copy a step, not the loop over chunks
    around it, which holds more shared loads and a global one."""
    from dpt_tpu_torch.probes import sass

    (_, a), = sass.loop_counts(_SASS_P4, r"sublane_kernel")
    assert (a["steps"], a["per_step"], a["lds_per_step"],
            a["ldg_per_step"]) == (2, 2.5, 1.0, 0.0)
    (_, d), = sass.loop_counts(_SASS_P4, r"rows_kernel", loads=("FADD",))
    assert d["steps"] == 2 and d["loop_instructions"] == 10
    assert d["ldg_per_step"] == 0.0 and d["by_opcode"]["UBLKCP"] == 1.0
    assert d["lds_per_step"] == 1.5
    (_, chunk), = sass.loop_counts(_SASS_P4, r"rows_kernel")
    assert chunk["ldg_per_step"] == 0.5 and chunk["lds_per_step"] == 2.0


def test_vector_ops_rounds_each_operation():
    """E's plain version is the float32 chain rounded at every multiply
    and add (the kernel's, built with -fmad=false), as numpy spells it."""
    x = _seeded_inputs(9)["x"]
    acc = np.zeros_like(x)
    for _ in range(3):
        v = x + acc
        for _ in range(tp4.MATH_OPS):
            v = v * np.float32(tp4.MUL) + np.float32(tp4.ADD)
        acc = v
    np.testing.assert_array_equal(tp4.vector_ops(_t(x), 3).numpy(), acc)


# --- P7 and P8 ---


@pytest.mark.parametrize("i", P7_INDICES)
@pytest.mark.parametrize("probe", ["scalar_load_from_vmem",
                                   "scalar_extract"])
def test_p7_row_loads_match_jax(jax_kernels, probe, i):
    rng = np.random.default_rng(11)
    idx = np.array([i], dtype=np.int32)
    for table in (np.arange(8 * 128, dtype=np.float32).reshape(8, 128),
                  rng.normal(size=(8, 128)).astype(np.float32)):
        want = jax_kernels[f"probe_{probe}"](idx, table)
        got = getattr(tp7, probe)(_t(idx), _t(table))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("probe", ["smem_stack_while", "int_vector_ops"])
def test_p7_no_input_kernels_match_jax(jax_kernels, probe):
    want = jax_kernels[f"probe_{probe}"]()
    got = getattr(tp7, probe)("cpu")
    assert str(got.dtype).split('.')[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    if probe == "smem_stack_while":
        assert (want == 11.0).all()


@pytest.mark.parametrize("i", P8_INDICES)
@pytest.mark.parametrize("probe", ["dyn_lane_slice", "dyn_roll",
                                   "scalar_dyn_lane", "dyn_sublane_row"])
def test_p8_matches_jax(jax_kernels, probe, i):
    rng = np.random.default_rng(13)
    idx = np.array([i], dtype=np.int32)
    for t in (np.arange(8 * tp8.N, dtype=np.float32).reshape(8, tp8.N),
              rng.normal(size=(8, tp8.N)).astype(np.float32)):
        if probe == "dyn_sublane_row":
            packed = t.T.reshape(tp8.N // 16, 128)  # the script's packing
            np.testing.assert_array_equal(tp8.pack_nodes(_t(t)).numpy(),
                                          packed)
            t = packed
        want = jax_kernels[f"probe_{probe}"](idx, t)
        got = getattr(tp8, probe)(_t(idx), _t(t))
        np.testing.assert_array_equal(got.numpy(), want)


def test_p8_probe_lines_hold_on_the_cpu():
    assert all(ok for _, ok in tp8.probe_lines("cpu"))
    assert all(ok for _, ok, _ in tp7.probe_lines("cpu"))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(8, 128)
    i = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        tp3.axis1_gather(x, i.float())
    with pytest.raises(ValueError):
        tp3.axis0_gather(x, i)  # [64, 128] wanted
    with pytest.raises(ValueError):
        tp4.lane_gathers(x, i, 3)  # K not built
    with pytest.raises(ValueError):
        tp4.sublane_gather(x, i, -1)
    with pytest.raises(ValueError):
        tp4.row_blocks(torch.zeros(4, 128), torch.zeros(3, dtype=torch.int32))
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tp8.dyn_roll(idx, torch.zeros(8, 64))  # fewer than 128 columns
    with pytest.raises(ValueError):
        tp7.scalar_load_from_vmem(idx[:0], torch.zeros(8, 128))
    with pytest.raises(ValueError):
        tp7.smem_stack_while("meta")


def test_latency_bound():
    """2,000 steps of 141 dependent operations at 4 clocks each and
    1.98 GHz: 0.570 ms."""
    assert probes.latency_bound_ms(2000, 141, 4) == pytest.approx(
        2000 * 141 * 4 / 1.98e9 * 1e3, rel=1e-12)
    assert probes.latency_bound_ms(2000, 141, 4) == pytest.approx(0.570,
                                                                  abs=5e-4)
    assert probes.latency_bound_ms(2000, 141, 4, clock_hz=0.99e9) == (
        pytest.approx(1.1394, abs=1e-4))


def test_share_against_the_larger_bound():
    """E's row: a chain of CHAIN_OPS = 141 dependent operations a step;
    its share is the latency bound over the kernel time where that bound is
    the larger, and the card's operations bound where it is.  The other
    rows have no chain and keep the card's bound."""
    a = {k: torch.as_tensor(v)
         for k, v in tp4.inputs(np.random.default_rng(0)).items()}
    lns = tp4.launches(a)
    math = lns["crossbar_math"]
    assert tp4.CHAIN_OPS == 141 and math.chain_ops == tp4.CHAIN_OPS
    assert math.ops == {"f32": 1024 * tp4.ITERS * 141}
    m = probes.launch_bounds(math, 1.1825, 4.0)
    assert m["bound_by"] == "operations"
    assert m["latency_bound_ms"] == pytest.approx(0.5697, abs=1e-4)
    assert m["latency_bound_ms"] > m["bound_ms"]
    assert m["share"] == pytest.approx(m["latency_bound_ms"] / 1.1825)
    # a latency under the operations bound leaves the share to the latter
    low = probes.launch_bounds(math, 1.1825, 0.01)
    assert low["share"] == pytest.approx(low["bound_ms"] / 1.1825)
    # every other loop row is a chain of one dependent add a step of each
    # element's sum (B: K adds a step), its latency bound the steps x chain
    # x 4.0 clocks at 1.98 GHz, the larger bound at these rows' kernel times
    g = {k: torch.as_tensor(v)
         for k, v in zip(("x", "idx", "x0", "idx0"),
                         tp3.inputs(np.random.default_rng(0)))}
    rows = {**{n: ln for n, ln in lns.items() if n != "crossbar_math"},
            **tp3.launches(g["x"], g["idx"], g["x0"], g["idx0"])}
    chains = {"crossbar_sublane": (2000, 1), "crossbar_lanes_K1": (2000, 1),
              "crossbar_lanes_K4": (500, 4), "crossbar_lanes_K12": (166, 12),
              "crossbar_fused": (2000, 1), "crossbar_rows": (2000, 1),
              "gather_axis1": (1000, 1), "gather_axis0": (100, 1)}
    assert sorted(rows) == sorted(chains)
    for name, ln in rows.items():
        steps, chain = chains[name]
        assert (ln.steps, ln.chain_ops) == (steps, chain), name
        m = probes.launch_bounds(ln, 0.1, 4.0)
        want = steps * chain * 4.0 / 1.98e9 * 1e3
        assert m["latency_bound_ms"] == pytest.approx(want, rel=1e-12)
        assert m["latency_bound_ms"] > m["bound_ms"], name
        assert m["share"] == pytest.approx(want / 0.1)
        # without the card's clocks only the card's bound is taken
        m = probes.launch_bounds(ln, 0.1)
        assert "latency_bound_ms" not in m
        assert m["share"] == pytest.approx(m["bound_ms"] / 0.1)
    # P4-c: 2,000 adds x 4 clocks at 1.98 GHz; P4-b at K = 12, 1,992
    assert probes.launch_bounds(rows["crossbar_fused"], 0.1, 4.0)[
        "latency_bound_ms"] == pytest.approx(2000 * 4 / 1.98e9 * 1e3)
    assert probes.launch_bounds(rows["crossbar_lanes_K12"], 0.1, 4.0)[
        "latency_bound_ms"] == pytest.approx(1992 * 4 / 1.98e9 * 1e3)


# B's and C's layout on the card, mirrored from crossbar.cu (`fill_copies`,
# `LanesGroup`, kBanks, kGroupLoads, kFusedThreads) for the CPU test below;
# the card tests hold the kernels themselves.
BANKS = 32
GROUP_LOADS = 32
FUSED_THREADS = 32


def _replica_offset(word, lane):
    """The float offset that `lane` reads `word` at in a table copied once
    a bank: word * 32 + lane % 32, always in bank lane % 32."""
    return word * BANKS + lane % BANKS


def _bank_copies(table):
    """The table the kernel builds from `table` (its last dimension the
    words): each word BANKS times, in the order of `_replica_offset`."""
    return table.unsqueeze(-1).expand(*table.shape, BANKS).reshape(
        *table.shape[:-1], -1)


def _lanes_group(K):
    """B's steps a group: 32 // K, and 1 at K = 12."""
    return 1 if K > 4 else GROUP_LOADS // K


def _lanes_copies(x, K):
    """B's table of each row of x: the row's words copied once a bank, then
    its first _lanes_group(K) - 1 words again, so that a group's step u
    reads word j + u of it where j is the group's first word; [rows, (128
    + U - 1) * 32]."""
    return _bank_copies(torch.cat([x, x[:, :_lanes_group(K) - 1]], dim=1))


def _lanes_words(idx, k):
    """B: the word of its row each element looks up at step k, (idx + k) %
    128 (the sum wrapping in int32, as in JAX)."""
    return torch.remainder(idx + k, tp4.LANES)


def _fused_words(lane, srow, k):
    """C: the word of x (flat) each element looks up at step k: s * 128 +
    (lane[s, c] + k) % 128, s = (srow + k) % 8."""
    s = torch.remainder(srow + k, tp4.ROWS).long()
    cols = torch.arange(tp4.LANES, device=lane.device).expand(tp4.ROWS,
                                                              tp4.LANES)
    return s * tp4.LANES + torch.remainder(lane[s, cols] + k,
                                           tp4.LANES).long()


def _wrap_tile(rng, rows):
    """An int32 [rows, 128] index tile near +-2^31, whose sums with k wrap
    in int32."""
    near = rng.integers(0, 64, (rows, tp4.LANES))
    return np.where(rng.random((rows, tp4.LANES)) < 0.5, 2**31 - 1 - near,
                    -2**31 + near).astype(np.int32)


def _wrap_tiles(rng):
    """Index tiles near +-2^31 (B's idx, C's lane and srow)."""
    idx = _wrap_tile(rng, tp4.ROWS)
    return {"idx": idx, "lane": idx, "srow": _wrap_tile(rng, tp4.ROWS)}


def _lookup_tiles(rng, pattern):
    if pattern == "wrap":
        return _wrap_tiles(rng)
    return tp4.index_patterns(rng)[pattern]


@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
def test_bank_copies_make_every_lookup_one_wavefront(pattern):
    """B's and C's layout as crossbar.cu builds it (each table copied once
    a bank, B's rows followed by their first U - 1 words again for its
    groups of U steps): a lookup through the copies equals the direct lookup,
    and at every step a warp's 32 lanes read 32 distinct banks, in the
    copies and in C's lane table.  On the one-bank tiles the uncopied table
    puts a warp's lanes on one bank at every step, on 4 distinct words of
    B's row and 32 of C's x.  The words are the plain versions' (summed
    over the steps they give lane_gathers_reference and
    fused_lookup_reference), wrapping as int32 sums do."""
    rng = np.random.default_rng(31)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32))
    t = {k: torch.as_tensor(v) for k, v in _lookup_tiles(rng, pattern).items()}
    lane = torch.arange(tp4.ROWS * tp4.LANES).reshape(tp4.ROWS, tp4.LANES)
    lane = lane % BANKS  # each element's lane in its warp
    rows = {K: _lanes_copies(x, K) for K in tp4.KS}
    assert rows[1].shape == (tp4.ROWS, (tp4.LANES + 31) * BANKS)
    assert rows[12].shape == (tp4.ROWS, tp4.LANES * BANKS)
    flat = _bank_copies(x.reshape(-1))
    acc_b, acc_c = torch.zeros_like(x), torch.zeros_like(x)
    for k in [*range(40), 127, 128, 1999, 2000]:
        wb = _lanes_words(t["idx"], k).long()
        want = (t["idx"].numpy().astype(np.int64) + k) % 2**32 % tp4.LANES
        np.testing.assert_array_equal(wb.numpy(), want)
        # B: step k is step u of a group whose first step reads word j
        offs = []
        for K in tp4.KS:
            u = k % _lanes_group(K)
            j = _lanes_words(t["idx"], k - u).long()
            offs.append(_replica_offset(j + u, lane))
            assert torch.equal(torch.gather(rows[K], 1, offs[-1]),
                               torch.gather(x, 1, wb))
        wc = _fused_words(t["lane"], t["srow"], k)
        oc = _replica_offset(wc, lane)
        assert torch.equal(flat[oc], x.reshape(-1)[wc])
        # C's lane table (a warp a block): lane l reads row s at s * 32 + l
        s = torch.remainder(t["srow"] + k, tp4.ROWS)
        ol = s * FUSED_THREADS + lane
        for off in (*offs, oc, ol):
            banks = (off % BANKS).reshape(-1, 32).sort(dim=1).values
            assert torch.equal(banks, torch.arange(32).expand(32, 32))
        if pattern == "one_bank":
            for w, n in ((wb, 4), (wc, 32)):
                warps = w.reshape(-1, 32)
                assert bool((warps % 32 == warps[:, :1] % 32).all())
                assert {len(set(r.tolist())) for r in warps} == {n}
        if k < 40:
            for q in range(4):
                acc_b = acc_b + torch.gather(x + float(q), 1, wb)
            acc_c = acc_c + x.reshape(-1)[wc]
    assert torch.equal(acc_b, tp4.lane_gathers_reference(x, t["idx"], 4, 40))
    assert torch.equal(acc_c, tp4.fused_lookup_reference(x, t["lane"],
                                                         t["srow"], 40))


# P3-b's layout on the card, mirrored from crossbar.cu (`column_kernel`,
# kColumnThreads, kColumnGroup) for the CPU test below.
COLUMN_THREADS = 32
COLUMN_GROUP = 32
COLUMN_STEPS = [0, 1, COLUMN_GROUP - 1, COLUMN_GROUP + 1, 100, 103]


def _bits(t):
    """A float32 tensor's bits: equal bits tell -0.0 from +0.0."""
    return t.contiguous().view(torch.int32)


def _row_tile(rng, pattern):
    """P3-b's [64, 128] index tile of a pattern."""
    if pattern == "wrap":
        return _wrap_tile(rng, tp3.ROWS_AXIS0)
    return tp3.row_patterns(rng)[pattern]


def _column_copies(x0):
    """Each one-warp block's copy as `column_kernel` builds it: block b
    (tile row b // 4) copies columns (b % 4) * 32 .. + 31 of the 64 rows,
    lane t's word of row j at j * 32 + t, then rows 0 .. U - 2 again;
    [256 blocks, (64 + U - 1) * 32]."""
    rows = torch.cat([x0, x0[:COLUMN_GROUP - 1]], dim=0)
    return torch.stack([
        rows[:, b % 4 * COLUMN_THREADS:(b % 4 + 1) * COLUMN_THREADS]
        .reshape(-1) for b in range(x0.numel() // COLUMN_THREADS)])


@pytest.mark.parametrize("steps", COLUMN_STEPS)
@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
def test_column_copies_read_their_own_bank(jax_kernels, pattern, steps):
    """P3-b's layout as crossbar.cu `column_kernel` builds it: step k, step
    u of the group from step g = k - k % U, reads its block's copy at
    ((j0 + g) % 64 + u) * 32 + lane (one base a group, the offsets fixed,
    the sum wrapping in int32), which is x0[(j0 + k) % 64, c] and always
    the lane's own bank, so a warp's 32 lanes read 32 distinct banks at
    every step, even where all read one row (the one-bank tile).  The
    words summed in the order of k equal the plain version bit for bit, at
    0 steps, within and off a group and at the TPU script's 100 steps,
    where they also equal JAX's `kern0`."""
    rng = np.random.default_rng(34)
    x0 = torch.as_tensor(rng.normal(size=(tp3.ROWS_AXIS0, tp3.LANES))
                         .astype(np.float32))
    idx0 = torch.as_tensor(_row_tile(rng, pattern))
    copies = _column_copies(x0)
    assert copies.shape == (256, (64 + COLUMN_GROUP - 1) * COLUMN_THREADS)
    e = torch.arange(x0.numel())
    block, lane, col = e // COLUMN_THREADS, e % COLUMN_THREADS, e % tp3.LANES
    j0 = idx0.reshape(-1).long()
    acc = torch.zeros(x0.numel())
    for k in range(steps):
        g = k - k % COLUMN_GROUP
        base = (j0 + g) & (tp3.ROWS_AXIS0 - 1)  # the low bits, as uint32
        off = (base + k - g) * COLUMN_THREADS + lane
        assert torch.equal(off % BANKS, lane)
        word = copies[block, off]
        row = torch.remainder(idx0 + k, tp3.ROWS_AXIS0).reshape(-1).long()
        assert torch.equal(_bits(word), _bits(x0[row, col]))
        acc = acc + word
    acc = acc.reshape(x0.shape)
    want = tp3.axis0_gather_reference(x0, idx0, steps)
    assert torch.equal(_bits(acc), _bits(want))
    if steps == tp3.ITERS_AXIS0:
        np.testing.assert_array_equal(
            acc.numpy(), jax_kernels["kern0"](x0.numpy(), idx0.numpy()))


@pytest.mark.parametrize("steps", [0, 1, 31, 33, tp3.ITERS_AXIS1, 1003])
@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
def test_axis1_gather_is_lane_gathers_at_k1(jax_kernels, pattern, steps):
    """P3-a launches P4-b's kernel at K = 1, whose table holds x + 0.0f:
    on an x with planted -0.0 entries (which x + 0.0 turns into +0.0), and
    on indices that wrap, P4-b's plain version at K = 1 equals P3-a's bit
    for bit, since a sum from +0 never becomes -0 by adding a zero of
    either sign; at the TPU script's 1,000 steps both equal JAX's `kern`."""
    rng = np.random.default_rng(35)
    x = rng.normal(size=(tp4.ROWS, tp4.LANES)).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = -0.0
    x = torch.as_tensor(x)
    idx = torch.as_tensor(_lookup_tiles(rng, pattern)["idx"])
    negative_zero = _bits(x) == -2**31
    assert bool(negative_zero.any()) and not bool(
        (_bits(x + 0.0) == -2**31).any())
    # some element's first lookup reads a planted -0.0
    first = torch.gather(negative_zero, 1,
                         torch.remainder(idx, tp4.LANES).long())
    assert bool(first.any())
    got = tp4.lane_gathers_reference(x, idx, 1, steps)
    want = tp3.axis1_gather_reference(x, idx, steps)
    assert torch.equal(_bits(got), _bits(want))
    if steps == tp3.ITERS_AXIS1:
        np.testing.assert_array_equal(
            want.numpy(), jax_kernels["kern"](x.numpy(), idx.numpy()))


def test_op_chain_reference_rounds_each_operation():
    """The bare chain's plain version (what the card's clocks a dependent
    operation are read from) rounds each multiply and add to float32, as
    the kernel does under -fmad=false: numpy float32 gives the same ends."""
    x = np.random.default_rng(5).normal(size=(tp4.ROWS, tp4.LANES)).astype(
        np.float32)
    got = tp4.op_chain_reference(torch.as_tensor(x), steps=3)
    v = x.reshape(-1)[:32].copy()
    for _ in range(3 * tp4.OP_CHAIN_PAIRS):
        v = v * np.float32(tp4.MUL) + np.float32(tp4.ADD)
    assert got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_array_equal(got.numpy(), v)


def test_op_cycles_refuses_cpu(monkeypatch):
    """The clocks are read only on the card: a CPU tile raises before the
    library is loaded."""
    from dpt_tpu_torch.kernels import build

    def refuse():
        raise AssertionError("the probe library was loaded")

    monkeypatch.setattr(build, "load_probe_library", refuse)
    with pytest.raises(ValueError, match="CUDA"):
        tp4.op_cycles(torch.zeros((tp4.ROWS, tp4.LANES)))
    with pytest.raises(ValueError, match="CUDA"):
        tp4.chain_cycles(torch.zeros((tp4.ROWS, tp4.LANES)))


def test_dyn_start_is_jax_indexing():
    i = torch.tensor([-9, -8, -1, 0, 5, 7, 8, 100], dtype=torch.int32)
    assert probes.dyn_start(i, 8).tolist() == [0, 0, 7, 0, 5, 7, 7, 7]
    assert probes.dyn_start(i, 8, 4).tolist() == [0, 0, 4, 0, 4, 4, 4, 4]


# --- on the card: each kernel against its plain version, bit for bit ---


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_cases(a, t8, packed):
    """kernel -> (wrapper call, plain call) on the tensors `a` (seeded
    inputs on the card), 64 steps for the loops."""
    n = 64
    idx = a["idx8"]
    return {
        "gather_axis1": (lambda: tp3.axis1_gather(a["x"], a["idx"], n),
                         lambda: tp3.axis1_gather_reference(a["x"], a["idx"],
                                                            n)),
        "gather_axis0": (lambda: tp3.axis0_gather(a["x0"], a["idx0"], n),
                         lambda: tp3.axis0_gather_reference(a["x0"],
                                                            a["idx0"], n)),
        "crossbar_sublane": (
            lambda: tp4.sublane_gather(a["x"], a["sub"], n),
            lambda: tp4.sublane_gather_reference(a["x"], a["sub"], n)),
        **{f"crossbar_lanes_K{K}": (
            lambda K=K: tp4.lane_gathers(a["x"], a["idx"], K, n),
            lambda K=K: tp4.lane_gathers_reference(a["x"], a["idx"], K,
                                                   n // K)) for K in tp4.KS},
        "crossbar_fused": (
            lambda: tp4.fused_lookup(a["x"], a["idx"], a["sub"], n),
            lambda: tp4.fused_lookup_reference(a["x"], a["idx"], a["sub"],
                                               n)),
        "crossbar_rows": (lambda: tp4.row_blocks(a["tab"], a["rows"]),
                          lambda: tp4.row_blocks_reference(a["tab"],
                                                           a["rows"])),
        "crossbar_math": (lambda: tp4.vector_ops(a["x"], n),
                          lambda: tp4.vector_ops_reference(a["x"], n)),
        "scalar_load": (
            lambda: tp7.scalar_load_from_vmem(idx, a["x"]),
            lambda: tp7.scalar_load_from_vmem_reference(idx, a["x"])),
        "scalar_extract": (
            lambda: tp7.scalar_extract(idx, a["x"]),
            lambda: tp7.scalar_extract_reference(idx, a["x"])),
        "smem_stack": (lambda: tp7.smem_stack_while(a["x"].device),
                       lambda: tp7.smem_stack_while_reference(a["x"].device)),
        "int_vector_ops": (
            lambda: tp7.int_vector_ops(a["x"].device),
            lambda: tp7.int_vector_ops_reference(a["x"].device)),
        **{name: (lambda name=name: getattr(tp8, name)(idx, t8),
                  lambda name=name: getattr(tp8, f"{name}_reference")(idx,
                                                                      t8))
           for name in ("dyn_lane_slice", "dyn_roll", "scalar_dyn_lane")},
        "dyn_sublane_row": (
            lambda: tp8.dyn_sublane_row(idx, packed),
            lambda: tp8.dyn_sublane_row_reference(idx, packed)),
    }


LOOP_KERNELS = ["gather_axis1", "gather_axis0", "crossbar_sublane",
                *(f"crossbar_lanes_K{K}" for K in tp4.KS), "crossbar_fused",
                "crossbar_rows", "crossbar_math"]
FEATURE_KERNELS = ["scalar_load", "scalar_extract", "smem_stack",
                   "int_vector_ops", "dyn_lane_slice", "dyn_roll",
                   "scalar_dyn_lane", "dyn_sublane_row"]


def _exact_on_card(device, kernel, i):
    a = {k: torch.as_tensor(v, device=device)
         for k, v in _seeded_inputs(21).items()}
    a["idx8"] = torch.tensor([i], dtype=torch.int32, device=device)
    t8 = torch.as_tensor(np.random.default_rng(22).normal(
        size=(8, tp8.N)).astype(np.float32), device=device)
    call, plain = _card_cases(a, t8, tp8.pack_nodes(t8))[kernel]
    name = kernel.split("_K")[0]
    before = probes.launch_counts[name]
    got = call()
    torch.cuda.synchronize()
    assert probes.launch_counts[name] == before + 1
    assert got.device.type == "cuda" and torch.equal(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", LOOP_KERNELS)
def test_loop_kernel_exact_on_card(cuda, kernel):
    _exact_on_card(cuda, kernel, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 200, 511, -1, 600])
@pytest.mark.parametrize("kernel", FEATURE_KERNELS)
def test_feature_kernel_exact_on_card(cuda, kernel, i):
    _exact_on_card(cuda, kernel, i)


@pytest.mark.cuda
def test_vector_ops_exact_on_card_at_script_steps(cuda):
    """P4-e over 32 one-warp blocks at the TPU script's 2,000 steps equals
    its plain version bit for bit; its first warp alone (its own clocks an
    operation) computes the same 32 elements; the bare chain that reads
    the card's clocks a dependent operation equals its plain version, at
    a few clocks an operation (no launch count: an instrument)."""
    x = torch.as_tensor(np.random.default_rng(24).normal(
        size=(tp4.ROWS, tp4.LANES)).astype(np.float32), device=cuda)
    before = dict(probes.launch_counts)
    got = tp4.vector_ops(x)
    own, first = tp4.chain_cycles(x)
    cycles, ends = tp4.op_cycles(x)
    torch.cuda.synchronize()
    assert probes.launch_counts == {**before, "crossbar_math":
                                    before["crossbar_math"] + 2}
    assert torch.equal(got, tp4.vector_ops_reference(x, tp4.ITERS))
    assert torch.equal(first, got.reshape(-1)[:32])
    assert torch.equal(ends.cpu(), tp4.op_chain_reference(x.cpu()))
    assert 1.0 < cycles < 64.0 and 1.0 < own < 64.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 2003])
def test_row_blocks_exact_on_card_off_the_unroll(cuda, n):
    """P4-d at step counts that are no multiple of its stage of 16 steps:
    fewer than one stage (a short stage alone), and 2,003 (16 chunks of
    128 starts, the ring refilled through them, then a short stage of 3
    steps), with row blocks out of range (from the end, clamped) among
    them."""
    rng = np.random.default_rng(23)
    tab = torch.as_tensor(rng.normal(size=(tp4.TABLE_ROWS, tp4.LANES))
                          .astype(np.float32), device=cuda)
    rows = rng.integers(0, tp4.ROW_BLOCKS, n, dtype=np.int32)
    rows[[0, n // 2, n - 1]] = (-1, 600, 511)
    rows = torch.as_tensor(rows, device=cuda)
    before = probes.launch_counts["crossbar_rows"]
    got = tp4.row_blocks(tab, rows)
    torch.cuda.synchronize()
    assert probes.launch_counts["crossbar_rows"] == before + 1
    assert torch.equal(got, tp4.row_blocks_reference(tab, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("table_rows", [tp4.TABLE_ROWS, tp4.ROWS])
@pytest.mark.parametrize("n", [0, 1, G - 1, G + 1, S * G, S * G + 1, 2003])
def test_row_blocks_exact_on_card_around_the_ring(cuda, n, table_rows):
    """P4-d over 32 one-warp blocks, its row blocks bulk-copied into a ring
    of S stages of G steps, equals its plain version bit for bit with one
    launch counted: at 0 rows, within a stage, about one and about a whole
    turn of the ring, and at 2,003; rows that wrap (-1) and clamp (600,
    511) among them; on the TPU script's 4,096-row table and on an 8-row
    one, where every start clamps to 0."""
    rng = np.random.default_rng(27)
    tab = torch.as_tensor(rng.normal(size=(table_rows, tp4.LANES))
                          .astype(np.float32), device=cuda)
    rows = torch.as_tensor(_ring_rows(rng, n), device=cuda)
    before = probes.launch_counts["crossbar_rows"]
    got = tp4.row_blocks(tab, rows)
    torch.cuda.synchronize()
    assert probes.launch_counts["crossbar_rows"] == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got, tp4.row_blocks_reference(tab, rows))


@pytest.mark.cuda
def test_row_blocks_refuse_a_misaligned_table(cuda):
    """A table whose base is not 16-byte aligned (a bulk copy's source must
    be) is refused: the wrapper raises before any launch, and the C launch
    returns cudaErrorInvalidValue (1) and launches nothing; so do fewer
    than 8 rows and a negative row count on the C side.  The aligned table
    of the same values launches and is exact."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    rng = np.random.default_rng(28)
    flat = torch.as_tensor(rng.normal(size=tp4.TABLE_ROWS * tp4.LANES + 4)
                           .astype(np.float32), device=cuda)
    tab = flat[1:1 + tp4.TABLE_ROWS * tp4.LANES].view(tp4.TABLE_ROWS,
                                                      tp4.LANES)
    assert tab.is_contiguous() and tab.data_ptr() % 16 == 4
    rows = torch.as_tensor(_ring_rows(rng, 100), device=cuda)
    before = dict(probes.launch_counts)
    with pytest.raises(ValueError, match="aligned"):
        tp4.row_blocks(tab, rows)
    assert probes.launch_counts == before
    lib = load_probe_library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out = torch.full((tp4.ROWS, tp4.LANES), float("nan"), device=cuda)
    for t, n_rows, iters in ((tab, tp4.TABLE_ROWS, 100),
                             (flat, tp4.ROWS - 1, 100),
                             (flat, tp4.TABLE_ROWS, -1)):
        assert lib.dpt_probe_crossbar_rows(
            t.data_ptr(), n_rows, rows.data_ptr(), iters, out.data_ptr(),
            stream) == 1
    torch.cuda.synchronize()
    assert bool(out.isnan().all())  # nothing was launched
    aligned = tab.clone()
    assert aligned.data_ptr() % 16 == 0
    assert torch.equal(tp4.row_blocks(aligned, rows),
                       tp4.row_blocks_reference(aligned, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 7, 9, 2000])
@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
def test_sublane_exact_on_card(cuda, pattern, steps):
    """P4-a over 32 one-warp blocks on B and C's step loop equals its plain
    version bit for bit with one launch counted, its sub the pattern's
    srow tile (near +-2^31 for "wrap"), at 0 steps, within and just past a
    group of 8, and at the TPU script's 2,000."""
    rng = np.random.default_rng(29)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32), device=cuda)
    sub = torch.as_tensor(_lookup_tiles(rng, pattern)["srow"], device=cuda)
    before = probes.launch_counts["crossbar_sublane"]
    got = tp4.sublane_gather(x, sub, steps)
    torch.cuda.synchronize()
    assert probes.launch_counts["crossbar_sublane"] == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got, tp4.sublane_gather_reference(x, sub, steps))


@pytest.mark.cuda
def test_sublane_c_side_refuses(cuda):
    """A's C launch refuses a negative step count with
    cudaErrorInvalidValue (1), launching nothing, and launches at 0 and 10
    steps (an output then equal to the plain version)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    rng = np.random.default_rng(33)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32), device=cuda)
    sub = torch.as_tensor(rng.integers(0, tp4.ROWS, (tp4.ROWS, tp4.LANES),
                                       dtype=np.int32), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out = torch.full_like(x, float("nan"))
    for iters in (-1, -2**31):
        assert lib.dpt_probe_crossbar_sublane(
            x.data_ptr(), sub.data_ptr(), iters, out.data_ptr(), stream) == 1
    torch.cuda.synchronize()
    assert bool(out.isnan().all())  # nothing was launched
    for iters in (0, 10):
        assert lib.dpt_probe_crossbar_sublane(
            x.data_ptr(), sub.data_ptr(), iters, out.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, tp4.sublane_gather_reference(x, sub, iters))


# P3's steps on the card: 0, within and just past a group of 32, the TPU
# script's and off the group after it.
GATHER_STEPS = {1: [0, 1, 7, COLUMN_GROUP + 1, tp3.ITERS_AXIS1, 1003],
                0: [0, 1, 7, COLUMN_GROUP + 1, tp3.ITERS_AXIS0, 103]}


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
@pytest.mark.parametrize("axis,steps", [(a, n) for a in (1, 0)
                                        for n in GATHER_STEPS[a]])
def test_gather_exact_on_card(cuda, axis, steps, pattern):
    """P3-a (P4-b's kernel at K = 1, 8 blocks of 128) and P3-b (256
    one-warp blocks, each lane's column in its own bank) equal their plain
    versions bit for bit with one launch counted: at 0 steps, within and
    off a group, at the TPU script's 1,000 / 100 steps and 1,003 / 103; on
    the seeded, one-bank, identity and wrapping (near +-2^31) index tiles;
    P3-a on an x with planted -0.0 entries."""
    rng = np.random.default_rng(36)
    if axis == 1:
        x = rng.normal(size=(tp4.ROWS, tp4.LANES)).astype(np.float32)
        x[rng.random(x.shape) < 0.25] = -0.0
        idx = _lookup_tiles(rng, pattern)["idx"]
        call, plain = tp3.axis1_gather, tp3.axis1_gather_reference
    else:
        x = rng.normal(size=(tp3.ROWS_AXIS0, tp3.LANES)).astype(np.float32)
        idx = _row_tile(rng, pattern)
        call, plain = tp3.axis0_gather, tp3.axis0_gather_reference
    x, idx = torch.as_tensor(x, device=cuda), torch.as_tensor(idx,
                                                              device=cuda)
    name = f"gather_axis{axis}"
    before = dict(probes.launch_counts)
    got = call(x, idx, steps)
    torch.cuda.synchronize()
    assert probes.launch_counts == {**before, name: before[name] + 1}
    assert got.device.type == "cuda"
    assert torch.equal(_bits(got), _bits(plain(x, idx, steps)))


@pytest.mark.cuda
def test_gather_c_side_refuses(cuda):
    """P3-a's and P3-b's C launches refuse a negative step count (-1 and
    -2^31) with cudaErrorInvalidValue (1), launching nothing (a NaN-filled
    output stays so), and launch at 0 and 10 steps (an output then equal
    to the plain version)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    rng = np.random.default_rng(37)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for axis, rows, plain in ((1, tp4.ROWS, tp3.axis1_gather_reference),
                              (0, tp3.ROWS_AXIS0,
                               tp3.axis0_gather_reference)):
        x = torch.as_tensor(rng.normal(size=(rows, tp3.LANES))
                            .astype(np.float32), device=cuda)
        idx = torch.as_tensor(rng.integers(-1000, 1000, (rows, tp3.LANES),
                                           dtype=np.int32), device=cuda)
        launch = getattr(lib, f"dpt_probe_gather_axis{axis}")
        out = torch.full_like(x, float("nan"))
        for iters in (-1, -2**31):
            assert launch(x.data_ptr(), idx.data_ptr(), iters,
                          out.data_ptr(), stream) == 1, (axis, iters)
        torch.cuda.synchronize()
        assert bool(out.isnan().all())  # nothing was launched
        for iters in (0, 10):
            assert launch(x.data_ptr(), idx.data_ptr(), iters,
                          out.data_ptr(), stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, plain(x, idx, iters))


LOOKUP_KERNELS = [*(f"crossbar_lanes_K{K}" for K in tp4.KS), "crossbar_fused"]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [2000, 7, 2003])
@pytest.mark.parametrize("pattern", [*tp4.PATTERNS, "wrap"])
@pytest.mark.parametrize("kernel", LOOKUP_KERNELS)
def test_lookup_kernel_exact_on_card(cuda, kernel, pattern, steps):
    """P4-b (K = 1, 4, 12; 8 blocks of 128) and P4-c (32 blocks of one
    warp), over tables copied once a bank, equal their plain versions bit
    for bit, with one
    launch counted: at 2,000 steps, at step counts off the unroll (7 and
    2,003), on the seeded tile, the one-bank tile (a warp's lanes on
    distinct words of one bank at every step), the identity and indices
    near +-2^31 that wrap."""
    rng = np.random.default_rng(25)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32), device=cuda)
    t = {k: torch.as_tensor(v, device=cuda)
         for k, v in _lookup_tiles(rng, pattern).items()}
    name = kernel.split("_K")[0]
    before = probes.launch_counts[name]
    if name == "crossbar_lanes":
        K = int(kernel.split("_K")[1])
        got = tp4.lane_gathers(x, t["idx"], K, steps * K)
        plain = tp4.lane_gathers_reference(x, t["idx"], K, steps)
    else:
        got = tp4.fused_lookup(x, t["lane"], t["srow"], steps)
        plain = tp4.fused_lookup_reference(x, t["lane"], t["srow"], steps)
    torch.cuda.synchronize()
    assert probes.launch_counts[name] == before + 1
    assert got.device.type == "cuda" and torch.equal(got, plain)


@pytest.mark.cuda
def test_lookup_c_side_refuses(cuda):
    """B's and C's C launches, each in its one grid, refuse a K not built
    or a negative step count with cudaErrorInvalidValue (1), launching
    nothing, and launch at a K built and 0 or more steps (an output then
    equal to the plain version)."""
    from dpt_tpu_torch.kernels.build import load_probe_library

    lib = load_probe_library()
    rng = np.random.default_rng(26)
    x = torch.as_tensor(rng.normal(size=(tp4.ROWS, tp4.LANES))
                        .astype(np.float32), device=cuda)
    idx, srow = (torch.as_tensor(rng.integers(0, n, (tp4.ROWS, tp4.LANES),
                                              dtype=np.int32), device=cuda)
                 for n in (tp4.LANES, tp4.ROWS))
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def lanes(K, iters, out):
        return lib.dpt_probe_crossbar_lanes(
            x.data_ptr(), idx.data_ptr(), K, iters, out.data_ptr(), stream)

    def fused(iters, out):
        return lib.dpt_probe_crossbar_fused(
            x.data_ptr(), idx.data_ptr(), srow.data_ptr(), iters,
            out.data_ptr(), stream)

    out = torch.full_like(x, float("nan"))
    for K in (0, 2, 3, 5, 13, -4):
        assert lanes(K, 10, out) == 1, K
    for K in tp4.KS:
        assert lanes(K, -1, out) == 1, K
    assert fused(-1, out) == 1
    torch.cuda.synchronize()
    assert bool(out.isnan().all())  # nothing was launched
    for K in tp4.KS:
        for iters in (0, 10):
            assert lanes(K, iters, out) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, tp4.lane_gathers_reference(x, idx, K,
                                                               iters))
    assert fused(10, out) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, tp4.fused_lookup_reference(x, idx, srow, 10))
