"""The general traffic generator: sets the program up from a configuration
and drives it with a mix, one closed loop at a time.

A mix file (benchmark/traffic/<mix>.json) gives its `loop` and the
parameters of that loop; nothing else here knows a mix by name.

- "progressive": `render.renderer.render_progressive`, one batch in
  flight, batch b seeded with sample batch (start + b).  With
  "camera": "drag", every frame moves the orbit camera one step of a
  seeded drag, so the accumulation restarts each frame; the viewer waits
  until a frame is complete on the device before it reads the next
  camera state.
- "optimize": the step of `diff.optimize.optimize`: the tape loss and
  gradients (`diff.grads.tape_loss_and_grads`, the L2 loss) against a
  target rendered in set-up, one Adam update of the albedo, and the loss
  read on the host, one step after another, step k seeded with sample
  batch (start + k).

Set-up warms every shape the loop uses; then the loop runs for `seconds`
on the host clock.  With a tracer, the first `trace_units` units of the
window run under the profiler, which is stopped after the device has
finished them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from benchmark import scenes

MASK32 = 0xFFFFFFFF


class Spans:
    """Host spans by name (seconds), recorded around calls into the
    program."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def span(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t)

    def add(self, name, seconds):
        self.s.setdefault(name, []).append(seconds)


class Closed(Exception):
    """Raised from the loop's own callbacks when the window has closed."""


@dataclasses.dataclass
class Window:
    """What a window did: its units (batches, frames or steps) on the host
    clock, and what the check needs of the program's outputs."""

    loop: str
    t0: float = 0.0
    units: int = 0
    seconds: float = 0.0
    unit_s: list = dataclasses.field(default_factory=list)
    outputs: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


def seeded(seed, salt):
    """A numpy Generator of (seed, salt), for any whole number seed."""
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), salt])


class System:
    """The program under test, set up from a configuration: its scene,
    camera, render configuration and accel, on `device`."""

    def __init__(self, config, mix, seed, device, spans):
        from dpt_tpu_torch.accel.bvh import build_accel
        from dpt_tpu_torch.config import RenderConfig
        from dpt_tpu_torch.scene.builder import _scene_from_arrays
        from dpt_tpu_torch.scene.scene import Materials, make_area_lights

        self.config, self.mix, self.seed = config, mix, seed
        self.device = device
        self.spans = spans
        self.vertices, self.indices = scenes.mesh(config["mesh"])
        m = config["material"]
        f = torch.float32
        materials = Materials(
            albedo=torch.tensor([m["albedo"]], dtype=f, device=device),
            roughness=torch.tensor([m["roughness"]], dtype=f, device=device),
            emission=torch.tensor([m["emission"]], dtype=f, device=device),
            sss_albedo=torch.tensor([m["sss_albedo"]], dtype=f,
                                    device=device),
            sss_radius=torch.tensor([m["sss_radius"]], dtype=f,
                                    device=device))
        ls = config["lights"]
        lights = make_area_lights(
            [lt["position"] for lt in ls], [lt["normal"] for lt in ls],
            [lt["intensity"] for lt in ls], [lt["size"] for lt in ls],
            device=device)
        self.scene = _scene_from_arrays(self.vertices, self.indices,
                                        materials=materials, lights=lights,
                                        device=device)
        render = dict(config["render"])
        auto = render.pop("compact_frac") == "auto"
        self.cfg = RenderConfig(**render)
        cam = config["camera"]
        self.camera_arrays = scenes.orbit(cam["yaw_deg"], cam["pitch_deg"],
                                          cam["radius"], cam["fov_deg"])
        self.camera = self.make_camera(self.camera_arrays)
        rng = seeded(seed, 1)
        self.start = int(rng.integers(0, 1 << 32))
        with spans.span("setup.bvh"):
            self.accel = build_accel(self.scene, self.cfg)
            _sync(device)
        if auto:
            from dpt_tpu_torch.render.renderer import auto_compact_frac

            with spans.span("setup.capacity"):
                self.cfg = self.cfg.replace(compact_frac=auto_compact_frac(
                    self.scene, self.camera, self.cfg, self.accel))
        else:
            self.cfg = self.cfg.replace(
                compact_frac=config["render"]["compact_frac"])

    def make_camera(self, arrays):
        from dpt_tpu_torch.scene.camera import Camera

        return Camera(**{k: torch.as_tensor(np.asarray(v), device=self.device)
                         for k, v in arrays.items()})

    def batch(self, b):
        return (self.start + b) & MASK32


def settle():
    """Before a window: collect, then move what set-up made out of the
    collector's view, so that the window's collections scan only what the
    window makes."""
    gc.collect()
    gc.freeze()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def progressive(system, seconds, tracer=None):
    """A window of the "progressive" loop; returns its Window.  The check
    gets the units `check_units`, one drawn from `check_seeded_range` and
    the last unit complete in the window."""
    from dpt_tpu_torch.render.renderer import render_progressive, render_sample

    mix, dev, spans = system.mix, system.device, system.spans
    drag = mix["camera"] == "drag"
    win = Window("progressive")
    n_trace = mix["trace_units"] if tracer is not None else 0
    rng = seeded(system.seed, 2)
    lo, hi = mix["check_seeded_range"]
    keep = set(mix["check_units"]) | {int(rng.integers(lo, hi + 1))}
    cam0 = system.config["camera"]
    path = (scenes.drag_path(rng, mix["max_frames"], mix["step_deg"],
                             mix["pitch_max_deg"],
                             float(rng.uniform(0.0, 360.0)), 0.0)
            if drag else [])
    st = {"calls": 0, "frames": 0, "published": 0, "closing": False,
          "t0": 0.0, "t_change": 0.0, "t_end": 0.0}
    # What the check reads: each kept unit's sample (render_sample's
    # answer) and image (the accumulation after it), the image before
    # it, and the same of the last units.
    samples, images, cameras = {}, {}, {}
    recent_samples, recent = [], []

    def render_fn(scene, camera, cfg, b, accel):
        # Under a drag every frame restarts at b = 0; it takes the next
        # sample batch all the same.
        u = st["calls"] if drag else b
        st["calls"] += 1
        t = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            out = render_sample(scene, camera, cfg, system.batch(u), accel)
        spans.add("unit_host", time.perf_counter() - t)
        recent_samples.append((u, out))
        del recent_samples[:-3]
        if u in keep:
            samples[u] = out
        return out

    def unit_done(now):
        """Count a unit complete; True once the window has closed."""
        win.units += 1
        st["t_end"] = now
        if tracer is not None and tracer.on and win.units >= n_trace:
            _sync(dev)
            tracer.stop(units=st["calls"])
        return now - st["t0"] >= seconds

    def on_batch(b, img, metrics):
        # Units are published in order; under a drag each frame is batch
        # 0 of an accumulation of its own.
        u = st["published"]
        st["published"] += 1
        recent.append((u, img))
        del recent[:-2]
        if u in keep or (not drag and u + 1 in keep):
            images[u] = img
        if not drag:
            now = time.perf_counter()
            win.unit_s.append(now)
            if unit_done(now):
                raise Closed

    def camera_source():
        f = st["frames"]
        if st["closing"]:
            raise Closed
        if f:
            _sync(dev)  # the viewer shows frame f - 1 once it is complete
            now = time.perf_counter()
            win.unit_s.append(now - st["t_change"])
            # Once closed, one more camera change lets the loop publish
            # frame f - 1; the frame it starts is not counted.
            st["closing"] = unit_done(now)
        if f >= len(path):
            raise RuntimeError(f"the drag path holds {len(path)} frames; "
                               "raise max_frames in the mix")
        yaw, pitch = path[f]
        cameras[f] = scenes.orbit(yaw, pitch, cam0["radius"], cam0["fov_deg"])
        camera = system.make_camera(cameras[f])
        st["frames"] = f + 1
        st["t_change"] = time.perf_counter()
        return (yaw, pitch), camera

    warm = mix["warmup_units"]
    warm_fn = (lambda s, c, g, b, a:
               render_sample(s, c, g, system.batch(MASK32 - b), a))
    with spans.span("setup.warmup_loop"):
        if drag:
            # The viewer's first frames, on a path of their own.  Every
            # frame restarts the accumulation, so the source ends the loop.
            it = iter(scenes.drag_path(seeded(system.seed, 3), warm,
                                       mix["step_deg"], mix["pitch_max_deg"],
                                       0.0, 0.0))

            def warm_source():
                _sync(dev)
                yaw, pitch = next(it, (None, None))
                if yaw is None:
                    raise Closed
                return (yaw, pitch), system.make_camera(scenes.orbit(
                    yaw, pitch, cam0["radius"], cam0["fov_deg"]))

            try:
                render_progressive(system.scene, warm_source, system.cfg,
                                   system.accel, n_batches=1 << 40,
                                   render_fn=warm_fn)
            except Closed:
                pass
        else:
            render_progressive(system.scene, system.camera, system.cfg,
                               system.accel, n_batches=warm, render_fn=warm_fn)
        _sync(dev)
    settle()
    if tracer is not None:
        tracer.start()
    st["t0"] = time.perf_counter()
    try:
        render_progressive(system.scene,
                           camera_source if drag else system.camera,
                           system.cfg, system.accel, n_batches=1 << 40,
                           on_batch=on_batch,
                           render_fn=render_fn)
    except Closed:
        pass
    win.t0 = st["t0"]
    win.seconds = st["t_end"] - st["t0"]
    win.peak_bytes = peak_bytes(dev)
    _sync(dev)
    if tracer is not None and tracer.on:
        tracer.stop(units=st["calls"])
    last = win.units - 1  # the last unit complete in the window
    for u, img in recent:
        images[u] = img
    for u, out in recent_samples:
        samples[u] = out
    checked = sorted(u for u in keep | {last} if u <= last and u in images
                     and u in samples and (drag or u == 0 or u - 1 in images))
    win.outputs = {
        "units": checked,
        "samples": {u: samples[u] for u in checked},
        "images": images,
        "batches": {u: system.batch(u) for u in checked},
        "cameras": {u: cameras[u] if drag else system.camera_arrays
                    for u in checked},
        "accumulates": not drag,
    }
    return win


def optimize(system, seconds, tracer=None):
    """A window of the "optimize" loop; returns its Window.  Set-up renders
    the target and runs the first `warmup_units` steps, which the check
    follows: their losses, Adam's first moment after step 1 and the albedo
    after the last of them.  Of the window the check gets the last step:
    the albedo and Adam's state before it, its sample batch, and its loss,
    gradient and albedo after it."""
    from dpt_tpu_torch.diff.grads import merge_params, split_params
    from dpt_tpu_torch.diff.grads import tape_loss_and_grads
    from dpt_tpu_torch.diff.optimize import make_optimizer
    from dpt_tpu_torch.render.renderer import render_sample

    mix, dev, spans = system.mix, system.device, system.spans
    win = Window("optimize")
    target_batch = seeded(system.seed, 4).integers(0, 1 << 32)
    with spans.span("setup.target"):
        with torch.no_grad():
            target = render_sample(system.scene, system.camera, system.cfg,
                                   int(target_batch), system.accel)
        _sync(dev)
    params = {k: v.detach().clone()
              for k, v in split_params(system.scene, system.camera).items()}
    albedo = params["albedo"] = torch.full_like(params["albedo"],
                                                mix["start_albedo"])
    opt = make_optimizer("adam", mix["lr"], [albedo])

    def step(k):
        """One step; returns its loss (read on the host) and gradient."""
        t = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            s, c = merge_params(params, system.scene, system.camera)
            loss, grads = tape_loss_and_grads(s, c, system.cfg, target,
                                              sample_batch=system.batch(k),
                                              accel=system.accel)
            albedo.grad = grads["albedo"]
            opt.step()
            albedo.grad = None
            value = float(loss)
        spans.add("unit_host", time.perf_counter() - t)
        return value, grads["albedo"]

    def state():
        """The albedo and Adam's moments and step count, as they stand."""
        st = opt.state[albedo]
        return {"albedo": albedo.detach().clone(),
                "m": st["exp_avg"].clone(), "v": st["exp_avg_sq"].clone(),
                "step": int(st["step"])}

    n_warm = mix["warmup_units"]
    losses, first_m = [], None
    with spans.span("setup.warmup_loop"):
        for k in range(n_warm):
            losses.append(step(k)[0])
            if k == 0:
                first_m = opt.state[albedo]["exp_avg"].clone()
    after = albedo.detach().clone()
    spans.s.pop("unit_host", None)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    settle()
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    k = n_warm
    while True:
        before = state()
        loss, grad = step(k)
        k += 1
        win.units += 1
        now = time.perf_counter()
        win.unit_s.append(now)
        if tracer is not None and tracer.on and win.units >= mix[
                "trace_units"]:
            _sync(dev)
            tracer.stop(units=win.units)
        if now - t0 >= seconds:
            break
    win.t0 = t0
    win.seconds = now - t0
    win.peak_bytes = peak_bytes(dev)
    win.outputs = {
        "losses": losses,
        "first_grad": first_m / (1.0 - 0.9),
        "start": torch.full_like(after, mix["start_albedo"]),
        "after": after,
        "target_batch": int(target_batch),
        "batches": [system.batch(i) for i in range(n_warm)],
        "last": dict(before, batch=system.batch(k - 1), loss=loss,
                     grad=grad.detach(), after=albedo.detach().clone()),
    }
    return win


LOOPS = {"progressive": progressive, "optimize": optimize}
