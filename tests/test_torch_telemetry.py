"""The port's spans and counters (``gi_raytracer_tpu_torch.telemetry``) on
the CPU: recording follows the profiler, the records' ids and self
times, ``idle_by_span`` on synthetic events, the photon pass's rounds
against a hand count, and the exact ray counter.  The card's tests of the
shared clock, the marked syncs and K3's totals are in
``tests/test_torch_cuda.py``."""

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gi_raytracer_tpu_torch import telemetry
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.io import load_checkpoint, save_checkpoint
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render import photon
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (CAMERA_LOOK_AT, CAMERA_POS,
                                                  cornell_box)


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _nested():
    with telemetry.span("job", n=3):
        with telemetry.span("a"):
            with telemetry.sync("here"):
                pass
        with telemetry.span("b"):
            pass


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_nothing_is_recorded_without_a_profiler():
    _nested()
    assert telemetry.records() == []
    _profiled(_nested)
    assert [sp.name for sp in telemetry.records()] == ["job", "a", "sync",
                                                      "b"]
    _nested()
    assert len(telemetry.records()) == 4


def test_ids_roots_and_self_time_of_nested_spans():
    _profiled(_nested)
    _profiled(_nested)
    spans = telemetry.records()
    job, a, sync, b = spans[:4]
    assert [sp.id for sp in spans] == list(range(8))
    assert (job.parent, a.parent, sync.parent, b.parent) == (
        None, job.id, a.id, job.id)
    assert {sp.root for sp in spans[:4]} == {job.id}
    assert {sp.root for sp in spans[4:]} == {spans[4].id}
    assert job.attrs == {"n": 3} and sync.attrs == {"site": "here"}
    for sp in spans:
        assert sp.start_ns <= sp.end_ns
    own = telemetry.self_ns(spans)
    assert own[job.id] == job.ns - a.ns - b.ns
    assert own[a.id] == a.ns - sync.ns
    assert own[b.id] == b.ns and own[sync.id] == sync.ns
    count, total, slf = telemetry.summary(spans)["job"]
    assert count == 2 and slf == own[job.id] + own[spans[4].id]
    assert total == job.ns + spans[4].ns


def _span(name, start, end, i, parent=None):
    return telemetry.Span(name, start, end, i, parent,
                          i if parent is None else 0, {})


def test_idle_by_span_on_synthetic_events():
    spans = [_span("frame", 100, 1000, 0), _span("wave", 100, 600, 1, 0),
             _span("sync", 300, 400, 2, 1), _span("frame", 1200, 1500, 3)]
    events = [(100, 50),      # [100, 150)
              (120, 80),      # [120, 200): overlaps, so no gap at 150
              (350, 10),      # gap [200, 350) begins in "wave"
              (380, 20),      # gap [360, 380) begins in "sync"
              (700, 100),     # gap [400, 700) begins in "wave" (at 400
                              # the sync has ended)
              (1100, 50),     # gap [800, 1100) begins in "frame"
              (1160, 10),     # gap [1150, 1160) begins where no span is
              (1200, 5)]      # gap [1170, 1200) too
    got = telemetry.idle_by_span(events, spans)
    assert got == pytest.approx({"wave": 450e-9, "sync": 20e-9,
                                 "frame": 300e-9, telemetry.NONE: 40e-9})
    # events in any order; fewer than two leave no gap
    assert telemetry.idle_by_span(events[::-1], spans) == pytest.approx(got)
    assert telemetry.idle_by_span(events[:1], spans) == {}
    assert telemetry.idle_by_span([(0, 5), (10, 5)], []) == pytest.approx(
        {telemetry.NONE: 5e-9})


@pytest.fixture(scope="module")
def small_box():
    return cornell_box(SceneBuilder, meshgen, False).build(device="cpu")


def test_photon_rounds_against_a_hand_count(small_box, monkeypatch):
    """Each round's ``lanes`` is its chunk's slots and ``live`` the slots
    its stored mask left unstored (counted here from the mask the round
    is given); the batch is bit-equal to one made with recording off."""
    cfg = RenderConfig(photons=700, ray_chunk=256, seed=3)
    off = photon.trace_photons(small_box, cfg)
    seen = []
    attempts = photon._emit_attempts

    def count(scene, cfg, sampler, li, h_idx, uniform, chunk, rnd, active,
              *a):
        seen.append((chunk, rnd, active.shape[0], int(active.sum())))
        return attempts(scene, cfg, sampler, li, h_idx, uniform, chunk, rnd,
                        active, *a)

    monkeypatch.setattr(photon, "_emit_attempts", count)
    on = _profiled(lambda: photon.trace_photons(small_box, cfg))
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    spans = telemetry.records()
    rounds = [sp for sp in spans if sp.name == "photons.round"]
    assert [(sp.attrs["round"], sp.attrs["lanes"], sp.attrs["live"])
            for sp in rounds] == [s[1:] for s in seen]
    assert sorted({(c, n) for c, _, n, _ in seen}) == [
        (0, 256), (1, 256), (2, 188)]
    (root,) = [sp for sp in spans if sp.name == "photons"]
    assert {sp.root for sp in spans} == {root.id}
    assert {sp.parent for sp in rounds} == {root.id}
    # one count a round, and one more where a chunk stored every slot
    syncs = [sp for sp in spans if sp.name == "sync"
             and sp.attrs["site"] == "photons.live"]
    assert len(syncs) - len(rounds) == sum(
        max(r for c, r, _, _ in seen if c == ch) + 1 < cfg.photon_retries
        for ch in {c for c, _, _, _ in seen})
    assert 0 < sum(sp.attrs["live"] for sp in rounds) < sum(
        sp.attrs["lanes"] for sp in rounds)


def _renderer(scene, **kw):
    cfg = RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                       max_depth=2, **kw)
    return Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                    cfg, 16, 16)


def test_frame_spans_and_image_with_recording(small_box):
    r = _renderer(small_box)
    img, st = r.render(return_state=True)
    img_on, st_on = _profiled(lambda: r.render(return_state=True))
    assert torch.equal(img, img_on) and int(st["rays"]) == int(st_on["rays"])
    spans = telemetry.records()
    (frame,) = [sp for sp in spans if sp.name == "frame"]
    waves = [sp for sp in spans if sp.name == "wave"]
    assert [sp.attrs["wave"] for sp in waves] == [0, 1]
    assert {sp.parent for sp in waves} == {frame.id}
    for name in ("wave.inputs", "wave.trace", "wave.fold"):
        got = [sp for sp in spans if sp.name == name]
        assert [sp.parent for sp in got] == [w.id for w in waves], name
    assert {sp.root for sp in spans} == {frame.id}
    sites = [sp.attrs["site"] for sp in spans if sp.name == "sync"]
    assert sites.count("frame.active") == 2


def test_fog_march_spans_count_the_steps_marched(monkeypatch):
    """Each march of a fog frame is one ``fog.march`` span: its ``use``
    names the caller, ``lanes`` the lanes entering, ``blocks`` the blocks
    it ran and ``lane_steps`` the density points it evaluated (counted
    here at ``fog_density``); a block's five host waits are ``fog.block``
    syncs, and the image is bit-equal to the one made with recording
    off."""
    from gi_raytracer_tpu_torch.render import atmosphere

    b = cornell_box(SceneBuilder, meshgen, False)
    b.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                     2.0, 0.5, 2)
    r = _renderer(b.build(device="cpu"), ambient=(0.35, 0.35, 0.35))
    img, st = r.render(return_state=True)
    seen, points = [], [0, 0]
    march, density = atmosphere._march, atmosphere.fog_density

    def counted_density(scene, p):
        points[0] += p.numel() // 3
        points[1] += 1
        return density(scene, p)

    def counted_march(scene, cfg, ro, rd, tmin, tmax, has, *a, **kw):
        points[:] = [0, 0]
        out = march(scene, cfg, ro, rd, tmin, tmax, has, *a, **kw)
        entering = int((has & (tmin + cfg.shadow_bias < tmax)).sum())
        seen.append((kw.get("use", "scatter"), entering, points[1],
                     points[0]))
        return out

    monkeypatch.setattr(atmosphere, "fog_density", counted_density)
    monkeypatch.setattr(atmosphere, "_march", counted_march)
    img_on, st_on = _profiled(lambda: r.render(return_state=True))
    assert torch.equal(img, img_on) and int(st["rays"]) == int(st_on["rays"])
    spans = telemetry.records()
    marches = [sp for sp in spans if sp.name == "fog.march"]
    assert [(sp.attrs["use"], sp.attrs["lanes"], sp.attrs["blocks"],
             sp.attrs["lane_steps"]) for sp in marches] == seen
    # two waves of two bounces: a scattering march and a shadow march each
    assert [u for u, *_ in seen] == ["scatter", "shadow"] * 4
    assert sum(n for *_, n in seen) > 0
    blocks = [sp for sp in spans if sp.name == "sync"
              and sp.attrs["site"] == "fog.block"]
    assert len(blocks) == 5 * sum(sp.attrs["blocks"] for sp in marches)
    assert {sp.parent for sp in blocks} <= {sp.id for sp in marches}


def _write(ptr, values):
    """Add ``values`` to the int64 at ``ptr``, as a kernel adds its
    counts to pinned memory."""
    cells = (ctypes.c_int64 * len(values)).from_address(ptr)
    for k, v in enumerate(values):
        cells[k] += v


@pytest.mark.parametrize("slab", [telemetry.SLAB, 4],
                         ids=["one_slab", "past_a_slab"])
def test_counts_ptr_fills_the_spans_attributes(monkeypatch, slab):
    """While recording, ``counts_ptr`` gives each span zeros of its own
    that ``records`` reads into its attributes (also where the counts
    take more than one slab); off the profiler it gives None, and
    ``reset`` zeros the counts it hands out again."""
    monkeypatch.setattr(telemetry, "SLAB", slab)
    telemetry.reset()
    with telemetry.span("off") as sp:
        assert telemetry.counts_ptr(sp, "lanes") is None

    def job():
        for n in range(3):
            with telemetry.span("fog.march", use="shadow") as sp:
                _write(telemetry.counts_ptr(sp, "lanes", "lane_steps",
                                            "blocks"), (n, 32 * n, 1))
    _profiled(job)
    assert [sp.attrs for sp in telemetry.records()] == [
        {"use": "shadow", "lanes": n, "lane_steps": 32 * n, "blocks": 1}
        for n in range(3)]
    # counts added after the span closed (a kernel still running) show
    # in the next read
    _write(telemetry._rec.pending[0][2].data_ptr()
           + 8 * telemetry._rec.pending[0][3], (5,))
    assert telemetry.records()[0].attrs["lanes"] == 5
    telemetry.reset()
    _profiled(job)
    assert [sp.attrs["lanes"] for sp in telemetry.records()] == [0, 1, 2]


def _stand_in_kernel(fog, ro, rd, t0, tmax, has, ray_id, salt, step,
                     max_steps, block_steps, counts=None):
    """``cuda_fog.march``'s contract on the CPU, step by step over every
    lane: each lane's first scattering step, and the counts the kernel
    adds (the lanes entering, each lane's blocks of ``block_steps`` steps
    entered and their steps, the most blocks a lane entered)."""
    import types

    from gi_raytracer_tpu_torch.render import atmosphere
    from gi_raytracer_tpu_torch.sampling.rng import hash_u01
    scene = types.SimpleNamespace(fog=fog)
    cfg = RenderConfig(raymarch_stepsize=step)
    rid = (torch.arange(ro.shape[0]) if ray_id is None
           else ray_id & 0xFFFFFFFF)
    live = has & (t0 < tmax)
    found = torch.zeros_like(live)
    idx = torch.zeros(ro.shape[0], dtype=torch.int64)
    reach = torch.zeros(ro.shape[0], dtype=torch.int64)
    for i in range(max_steps):
        t = t0 + atmosphere._step_offsets(cfg, torch.tensor(i), t0.dtype)
        going = live & ~found & (t < tmax)
        if not going.any():
            break
        reach += going
        p = ro + t[:, None] * rd
        scat = going & (hash_u01(rid, i, salt)
                        < atmosphere.fog_density(scene, p))
        found |= scat
        idx = torch.where(scat, i, idx)
    blocks = torch.where(found, idx // block_steps + 1,
                         (reach + block_steps - 1) // block_steps) * live
    if counts is not None:
        _write(counts, (int(live.sum()),
                        int(torch.clamp(blocks * block_steps,
                                        max=max_steps).sum()),
                        int(blocks.max()) if blocks.numel() else 0))
    return found, idx.to(torch.int32)


@pytest.mark.parametrize("max_steps", [512, 100], ids=["512", "100"])
def test_fog_kernel_route_counts_as_the_blocked_march(monkeypatch,
                                                      max_steps):
    """``atmosphere.march`` on the kernel's route (here forced, the kernel
    stood in for by its contract on the CPU): the image is the torch
    route's bit for bit (t_hit rebuilt from the step index), and each
    ``fog.march`` span, its counts read from memory the kernel writes,
    carries the torch route's ``lanes``, ``blocks`` and ``lane_steps``."""
    from gi_raytracer_tpu_torch import routes
    from gi_raytracer_tpu_torch.ops import _cuda, cuda_fog

    b = cornell_box(SceneBuilder, meshgen, False)
    b.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                     2.0, 0.5, 2)
    r = _renderer(b.build(device="cpu"), ambient=(0.35, 0.35, 0.35),
                  raymarch_max_steps=max_steps)
    keys = ("use", "lanes", "blocks", "lane_steps")

    def marches():
        spans = [sp for sp in telemetry.records() if sp.name == "fog.march"]
        telemetry.reset()
        return spans

    want = _profiled(r.render)
    torch_spans = marches()
    monkeypatch.setattr(routes, "fog_march", lambda *a: ("kernel", []))
    monkeypatch.setattr(cuda_fog, "march", _stand_in_kernel)
    _cuda.reset_launches()
    got = _profiled(r.render)
    kernel_spans = marches()
    assert torch.equal(got, want)
    assert _cuda.plain_calls["fog_march"] == 0
    assert [sp.attrs["route"] for sp in torch_spans] == ["torch"] * 8
    assert [sp.attrs["route"] for sp in kernel_spans] == ["kernel"] * 8
    assert ([[sp.attrs[k] for k in keys] for sp in kernel_spans]
            == [[sp.attrs[k] for k in keys] for sp in torch_spans])
    assert sum(sp.attrs["lane_steps"] for sp in kernel_spans) > 0
    sites = {sp.attrs["site"] for sp in telemetry.records()
             if sp.name == "sync"}
    assert not sites & {"fog.block", "fog.lanes"}


def test_ray_counter_is_exact_past_2_24(small_box):
    """The counter is int64: one ray added to 2^24 + 1 is not lost, as it
    would be in float32."""
    r = _renderer(small_box)
    n = int(r.render(return_state=True)[1]["rays"]) // 2
    st = r.start()
    assert st["rays"].dtype == torch.int64
    st["rays"] = torch.tensor(2**24 + 1)
    st = r.step(st, 0)
    assert st["rays"].dtype == torch.int64
    assert int(st["rays"]) == 2**24 + 1 + int(r.block_wave(0)[1])
    assert n > 0


def test_checkpoint_with_a_float32_counter_resumes(small_box, tmp_path):
    """A checkpoint from before the counter was int64 (float32 ``rays``)
    resumes to the uninterrupted image and count."""
    r = _renderer(small_box)
    saved = {}

    def keep(st, s):
        if s == 0:
            saved.update({k: v.cpu().numpy() if torch.is_tensor(v)
                          else np.asarray(v) for k, v in st.items()})

    full, st_full = r.render(on_wave=keep, return_state=True)
    saved["rays"] = saved["rays"].astype(np.float32)
    path = str(tmp_path / "old.npz")
    save_checkpoint(path, meta={"seed": 0}, **saved)
    raw = load_checkpoint(path)
    raw.pop("meta")
    state = {k: torch.as_tensor(v) for k, v in raw.items()}
    state["wave"] = int(raw["wave"])
    assert state["rays"].dtype == torch.float32
    img, st = r.render(state=state, return_state=True)
    assert torch.equal(img, full)
    assert st["rays"].dtype == torch.int64
    assert int(st["rays"]) == int(st_full["rays"])


def test_report_tables_of_spans_and_idle():
    ms = 1_000_000
    spans = [_span("frame", 0, 1000 * ms, 0),
             _span("wave", 0, 600 * ms, 1, 0),
             _span("sync", 300 * ms, 400 * ms, 2, 1)]
    lines = telemetry.report(spans, [(0, 100 * ms), (300 * ms, 50 * ms),
                                     (500 * ms, 100 * ms)])
    i = lines.index("device idle by span    idle_s   share")
    rows = {line.split()[0]: line.split()[1:] for line in lines[1:i]}
    assert rows == {"frame": ["1", "1.0000", "0.4000"],
                    "wave": ["1", "0.6000", "0.5000"],
                    "sync": ["1", "0.1000", "0.1000"]}
    # idle [100, 300) ms began in "wave", [350, 500) ms in "sync"
    idle = {line.split()[0]: line.split()[1:] for line in lines[i + 1:]}
    assert idle == {"wave": ["0.2000", "57.1%"], "sync": ["0.1500", "42.9%"]}
    assert telemetry.report(spans, [])[-1] == \
        "device idle by span: no device events"


def test_chrome_events_on_the_traces_clock():
    spans = [_span("frame", 5_000, 9_000, 0), _span("sync", 6_000, 6_500, 1,
                                                    0)]
    spans[1].attrs["site"] = "here"
    meta, frame, sync = telemetry.chrome_events(spans, 1_000, pid=7)
    assert meta["args"] == {"name": "program spans"}
    assert (frame["ts"], frame["dur"], frame["pid"]) == (4.0, 4.0, 7)
    assert sync["args"] == {"site": "here", "id": 1, "parent": 0, "root": 0}
