"""The probes: H100 forms of the TPU probes under scripts/.

Each module is the counterpart of one JAX probe script, under its name,
with a hand-written CUDA kernel (csrc/probes/, built at first use into
`libdpt_probes_<hash>.so` by kernels/build.py `load_probe_library`), its
plain PyTorch version (`*_reference`), and a `main()` that times it on the
card (`python -m dpt_tpu_torch.probes.<name>`):

  - `r3_smem_proto` (P1): K1's nearest walk with the top levels of its
    record table staged in shared memory (csrc/probes/smem_walk.cu).
  - `probe_interleave` (P5) and `probe_interleave_any` (P6): P pointer-chase
    chains interleaved in each thread, the tile spread over 32 one-warp
    blocks (P5) or one thread-block cluster (P6, which adds the tile's
    any(hit) into the next index; csrc/probes/interleave.cu).
  - `probe_interleave2` (P2): walk-step variants A-D with a stack per
    chain, the tile over one cluster as P6's (csrc/probes/interleave2.cu).
  - `probe_gather` (P3): a lane gather within the rows of an [8, 128] tile
    and a row gather within the columns of a [64, 128] one, repeated
    (csrc/probes/crossbar.cu: the first on P4-b's kernel at K = 1, the
    second over 256 one-warp blocks); `xla_gather_probe` and `chase` are
    torch indexing, as XLA computed them outside any kernel.
  - `probe_crossbar` (P4): a row gather, K lane gathers a step, the two
    fused, row blocks of a 2 MB table, and 70 multiply-adds a step, each
    over one [8, 128] tile (csrc/probes/crossbar.cu; the last over 32
    one-warp blocks, bound by its chain's latency: `latency_bound_ms`).
  - `probe_pallas` (P7) and `probe_pallas2` (P8): the Mosaic feature checks,
    dynamic row, lane and scalar loads with an index read on the device,
    rolls, a stack in shared memory and integer vector ops
    (csrc/probes/features.cu).

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version.  The render path imports none of these modules.  They import
torch and numpy only, never jax or dpt_tpu.

The primitive probes list their launches at the TPU scripts' inputs as
`Launch` records (`launches(...)` in each module), which their `main`s
and chip_smoke.py time.
"""

from typing import Callable, NamedTuple

# Kernel launches per probe kernel.  Each wrapper adds one where it
# launches its CUDA kernel and nowhere else; the plain versions do not
# count.
launch_counts = {k: 0 for k in (
    "smem_walk", "interleave", "interleave_any", "interleave2",
    "gather_axis1", "gather_axis0",
    "crossbar_sublane", "crossbar_lanes", "crossbar_fused", "crossbar_rows",
    "crossbar_math",
    "scalar_load", "scalar_extract", "smem_stack", "int_vector_ops",
    "dyn_lane_slice", "dyn_roll", "scalar_dyn_lane", "dyn_sublane_row")}

# The card's peak rates for the primitive probes' bounds (NVIDIA H100 SXM:
# 132 SMs at the 1.98 GHz boost clock behind its 67e12 float32 FLOP/s and
# 3.35e12 HBM bytes/s).  Per SM and clock: 128 float32 lanes (an unfused
# add or multiply each), 64 int32 lanes, 32 shared-memory words (128 B),
# and 4 warp instructions issued (128 thread operations).
SMS = 132
CLOCK_HZ = 1.98e9
PEAK_BYTES_PER_S = 3.35e12
LANES_PER_CLOCK = {"f32": 128, "i32": 64, "lds": 32}
DISPATCH_PER_CLOCK = 128


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def card_line() -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def launch_ms(fn, inputs, n=20, sleep_cycles=50_000_000):
    """Device ms of each of `n` calls fn(*inputs[k % len(inputs)]) (after
    one warm-up call on each input), from CUDA events around each call, all
    queued behind a sleep kernel (~25 ms) so that the host has queued them
    before the device reaches the first: each span is device work alone."""
    import torch

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(sleep_cycles)
    for k, (start, end) in enumerate(events):
        start.record()
        fn(*inputs[k % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


class Launch(NamedTuple):
    """One launch of a primitive probe's kernel at given inputs."""

    label: str  # the TPU probe's line
    call: Callable  # the public wrapper, as the TPU probe runs its kernel
    plain: Callable  # the plain version on the same inputs
    steps: int  # loop steps a launch (1 for a feature check)
    ops: dict  # thread operations a launch, by pipe (see bound_ms)
    nbytes: int  # bytes a launch must move: inputs read, outputs written
    # Dependent operations a step of each element's chain, where each
    # element is one chain of dependent steps (see latency_bound_ms); 0
    # where no chain sets a least time.
    chain_ops: int = 0


def counter(name):
    """The launch_counts key of a `launches` entry (P4-b's K variants
    share one kernel)."""
    return name.split("_K")[0]


def launch_bounds(ln, kernel_ms, cycles_per_op=None):
    """A launch's bounds beside its kernel time: the card's (`bound_ms`),
    the one SM's, and for a launch with `chain_ops` the chain's latency
    bound at `cycles_per_op`, the card's clocks a dependent operation read
    apart from the kernel (`probe_crossbar.op_cycles`); `share` is the
    larger bound over the kernel time."""
    bound, by = bound_ms(ln.nbytes, ln.ops)
    out = {"kernel_ms": kernel_ms, "steps": ln.steps,
           "ns_per_step": kernel_ms * 1e6 / ln.steps,
           "bound_ms": bound, "bound_by": by,
           "sm_bound_ns_per_step":
               bound_ms(0, ln.ops, sms=1)[0] * 1e6 / ln.steps}
    latency = 0.0
    if ln.chain_ops and cycles_per_op is not None:
        latency = latency_bound_ms(ln.steps, ln.chain_ops, cycles_per_op)
        out["latency_bound_ms"] = latency
        out["cycles_per_op"] = cycles_per_op
    out["share"] = max(bound, latency) / kernel_ms
    return out


def time_launches(launches, n=20, cycles_per_op=None):
    """Each launch's kernel time on the card (median of `n` launches behind
    a sleep, `launch_ms`) beside its bounds (`launch_bounds`, the chains'
    latency at `cycles_per_op`): name -> dict."""
    import statistics

    return {name: launch_bounds(
        ln, statistics.median(launch_ms(ln.call, [()], n=n)), cycles_per_op)
        for name, ln in launches.items()}


def print_launches(probe, launches, timed, card, **extra):
    """A primitive probe's lines (the TPU probe's, ns a step beside the
    bound of one SM doing all of the launch's work and, for a chain, the
    chain's latency bound) and its JSON line (with `extra`)."""
    import json

    import torch

    for name, m in timed.items():
        if m["steps"] == 1:  # a feature check: launch-bound
            print(f"{launches[name].label}: {m['kernel_ms'] * 1e3:.2f} us a "
                  f"launch (bound {m['bound_ms'] * 1e3:.5f} us)", flush=True)
            continue
        bound = f"one SM's bound {m['sm_bound_ns_per_step']:.1f} ns a step"
        if "latency_bound_ms" in m:
            bound += ("; the chain's latency bound "
                      f"{m['latency_bound_ms']:.4f} ms at the card's "
                      f"{m['cycles_per_op']:.4f} clocks an operation, "
                      f"{100 * m['share']:.3g}% of the kernel")
        if "own_cycles_per_op" in m:
            bound += f"; its own chain {m['own_cycles_per_op']:.4f}"
        print(f"{launches[name].label}: {m['ns_per_step']:9.1f} ns a step "
              f"({m['kernel_ms']:.4f} ms a launch, {m['steps']} steps; "
              f"{bound})", flush=True)
    print(json.dumps({"probe": probe, "device": torch.cuda.get_device_name(0),
                      "card": card, "rows": timed, **extra}))


def bound_ms(nbytes, ops, sms=SMS):
    """(ms, by): the least time of work that moves `nbytes` through device
    memory and does `ops` ({"f32" | "i32" | "lds": thread operations}) on
    `sms` SMs: the larger of the bytes at PEAK_BYTES_PER_S and the
    operations, each pipe at its rate and all of them at the issue rate.
    With sms=1 it is the bound of a one-block kernel on the SM that runs
    its block, whose bytes (one SM's share of HBM is not fixed) are left
    out."""
    clocks = max([n / (LANES_PER_CLOCK[k] * sms) for k, n in ops.items()]
                 + [sum(ops.values()) / (DISPATCH_PER_CLOCK * sms)])
    t_ops = clocks / CLOCK_HZ
    t_bytes = nbytes / PEAK_BYTES_PER_S if sms == SMS else 0.0
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def latency_bound_ms(steps, chain_ops, cycles_per_op, clock_hz=CLOCK_HZ):
    """The least time of a chain of `steps` steps of `chain_ops` dependent
    operations each, `cycles_per_op` clocks apiece at `clock_hz`: no design
    shortens a dependent chain, whatever the card's operations rate."""
    return steps * chain_ops * cycles_per_op / clock_hz * 1e3


def dyn_start(i, dim, size=1):
    """JAX's start of a dynamic slice of `size` along an axis of `dim`
    (`ref[i]`, `pl.ds(i, size)`), for an int tensor i: a negative i counts
    from the end, then the start is clamped into [0, dim - size]."""
    return (i + (i < 0).to(i.dtype) * dim).clamp(0, dim - size)


def check_tensor(name, x, dtype, shape):
    """Raise unless x is a `dtype` tensor of `shape` (None: any size)."""
    if x.dtype != dtype or x.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{x.dtype} {list(x.shape)}")


def check_steps(n):
    """Raise unless a kernel's loop count n fits its int32 argument."""
    if not 0 <= n < 2**31:
        raise ValueError(f"steps must be in [0, 2**31), got {n}")


def on_device(*tensors):
    """The one device of `tensors`: "cuda" or "cpu"; raise on another
    device or a mix."""
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"the tensors are on several devices: {devs}")
    (dev,) = devs
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def launch_kernel(name, out, *args):
    """Launch the probe library's `dpt_probe_<name>`(*args, out, stream) on
    the current stream of out's device (tensors by their data pointers,
    ints as they are; every tensor contiguous), count it in
    launch_counts[name] and return out.  Raises on a failed build or
    launch."""
    import torch

    from dpt_tpu_torch.kernels.build import check_launch, load_probe_library

    lib = load_probe_library()
    err = getattr(lib, f"dpt_probe_{name}")(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a
          for a in (*args, out)),
        torch.cuda.current_stream(out.device).cuda_stream)
    check_launch(lib, name, err)
    launch_counts[name] += 1
    return out
