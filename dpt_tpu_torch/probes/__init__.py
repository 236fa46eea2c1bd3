"""The walk probes: H100 forms of the TPU probes under scripts/.

Each module is the counterpart of one JAX probe script, under its name,
with a hand-written CUDA kernel (csrc/probes/, built at first use into
`libdpt_probes_<hash>.so` by kernels/build.py `load_probe_library`), its
plain PyTorch version (`*_reference`), and a `main()` that times it on the
card (`python -m dpt_tpu_torch.probes.<name>`):

  - `r3_smem_proto` (P1): K1's nearest walk with the top levels of its
    record table staged in shared memory (csrc/probes/smem_walk.cu).
  - `probe_interleave` (P5) and `probe_interleave_any` (P6): P pointer-chase
    chains interleaved in one block; P6 adds the tile's any(hit) into the
    next index (csrc/probes/interleave.cu).
  - `probe_interleave2` (P2): walk-step variants A-D with a stack per chain
    (csrc/probes/interleave2.cu).

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version.  The render path imports none of these modules.  They import
torch and numpy only, never jax or dpt_tpu.
"""

# Kernel launches per probe kernel.  Each wrapper adds one where it
# launches its CUDA kernel and nowhere else; the plain versions do not
# count.
launch_counts = {"smem_walk": 0, "interleave": 0, "interleave_any": 0,
                 "interleave2": 0}


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
