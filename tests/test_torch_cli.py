"""The port's ``.scn`` directives and ``cli render``: a scene with every
directive loads to the JAX loader's arrays; ``cli render --device cpu``
writes a PNG that Pillow and ``io.load_png`` read back equal; a render
resumed from a checkpoint taken after its first wave equals the
uninterrupted render; a checkpoint whose meta record differs is
refused; ``render --profile DIR`` writes one torch.profiler trace and the
same PNG as without it; each subcommand takes the JAX CLI's options plus
``--device``."""

import json
import re

import numpy as np
import pytest
from PIL import Image

from gi_raytracer_tpu import cli as jax_cli
from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.scene.scn import load_scene as jax_load_scene
from gi_raytracer_tpu_torch import cli
from gi_raytracer_tpu_torch import io as tio
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.scene.scn import load_scene

from _torch_parity import assert_scene_arrays_equal

SCN = """# every directive the port reads
imTex tex.png 2 3
colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.3 0.2
checkerboardTex 0.9 0.9 0.9 0.1 0.1 0.1 4
mat 0 1 1 1
mat 2 1 1 1
mat 3 1 0.05 1 1.5
mat 4 1 0 1
box 0 -3 0 7 0.2 7 0 0 0 0
box 2 -2 1 1 1 1 0 0.3 0 1
sphere -1 -1.5 0 1 2
sphere 1.5 -1.8 -1 0.6 3
cone 0.5 -2.8 1.5 1.5708 0 0 0.6 1.5 1
heightFog 0 -1 0 8 4 8 0.8 0.85 0.9 0.3 1 2
light 0 3 0 8 8 8 0.3
samples 2 4 0.05
photons 3000
ambient 0.05 0.05 0.05
camera 0 0 -8 0 -1 0
"""


@pytest.fixture
def scene_dir(tmp_path):
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (12, 10, 4), dtype=np.uint8),
                    "RGBA").save(tmp_path / "tex.png")
    (tmp_path / "s.scn").write_text(SCN)
    return tmp_path


def test_scn_with_every_directive_loads_like_jax(scene_dir):
    path = str(scene_dir / "s.scn")
    want = jax_load_scene(path, JaxConfig(seed=4), dtype=np.float32)
    got = load_scene(path, RenderConfig(seed=4), device="cpu")
    s = got.scene
    assert (s.n_spheres, s.n_cones, s.has_fog, s.has_image_tex) == \
        (2, 1, True, True)
    assert s.textures.atlas.shape == (120, 4)
    assert_scene_arrays_equal(s, want.scene, atol=0)
    assert s.all_opaque == want.scene.all_opaque
    for k in ("photons", "min_samples", "max_samples", "noise_thresh",
              "ambient", "seed"):
        assert getattr(got.config, k) == getattr(want.config, k), k
    assert got.camera_pos == want.camera_pos


def _render(scene_dir, out, *extra):
    cli.main(["render", str(scene_dir / "s.scn"), "-o", str(out), "-W", "32",
              "-H", "32", "--max-depth", "4", "--device", "cpu", *extra])


def test_cli_render_writes_a_png(scene_dir, capsys):
    out = scene_dir / "out.png"
    _render(scene_dir, out, "--photons", "2000")
    log = capsys.readouterr().out
    assert "[scene] 24 tris, 2 spheres, 1 lights" in log
    assert "[photons] " in log and "Mrays/s honest" in log
    assert f"[out] {out}" in log
    img = tio.load_png(str(out))
    assert img.shape == (32, 32, 3) and img.max() > 0.05
    pil = np.asarray(Image.open(out).convert("RGB"), np.float32) / 255.0
    assert np.array_equal(img, pil)


class _Stop(Exception):
    pass


def test_cli_resume_equals_uninterrupted(scene_dir, monkeypatch, capsys):
    """Without the map here (its pass takes most of a CPU render); the
    card's run of chip_smoke.py resumes a render with one."""
    full = scene_dir / "full.png"
    _render(scene_dir, full, "--no-photons")
    ck = scene_dir / "ck.npz"
    save = tio.save_checkpoint

    def save_then_stop(*a, **kw):          # interrupted after wave 0
        save(*a, **kw)
        raise _Stop

    monkeypatch.setattr(tio, "save_checkpoint", save_then_stop)
    with pytest.raises(_Stop):
        _render(scene_dir, scene_dir / "never.png", "--no-photons",
                "--checkpoint", str(ck))
    monkeypatch.setattr(tio, "save_checkpoint", save)
    assert int(tio.load_checkpoint(str(ck))["wave"]) == 1
    resumed = scene_dir / "resumed.png"
    _render(scene_dir, resumed, "--no-photons", "--checkpoint", str(ck),
            "--resume")
    assert "[resume] wave 1" in capsys.readouterr().out
    assert np.array_equal(tio.load_png(str(resumed)), tio.load_png(str(full)))

    # another resolution: the meta record no longer matches
    with pytest.raises(ValueError, match="incompatible"):
        cli.main(["render", str(scene_dir / "s.scn"), "-o",
                  str(scene_dir / "x.png"), "-W", "16", "-H", "16",
                  "--max-depth", "4", "--device", "cpu", "--no-photons",
                  "--checkpoint", str(ck), "--resume"])


def _rays(log):
    """The ray count of a ``[render]`` line."""
    return re.search(r"\[render\] .* — (\S+) rays traced", log).group(1)


def test_cli_render_profile_writes_a_trace(scene_dir, capsys, monkeypatch):
    # the profile covers the photon pass too: 4 retry rounds, not 64, keep
    # its trace of the CPU's ops small (both renders take the same pass)
    build = cli._build

    def few_rounds(args):
        ls, cfg, cam = build(args)
        return ls, cfg.replace(photon_retries=4), cam

    monkeypatch.setattr(cli, "_build", few_rounds)
    plain, profiled = scene_dir / "plain.png", scene_dir / "profiled.png"
    _render(scene_dir, plain, "--photons", "2000")
    plain_log = capsys.readouterr().out
    trace_dir = scene_dir / "trace"
    _render(scene_dir, profiled, "--photons", "2000", "--profile",
            str(trace_dir))
    log = capsys.readouterr().out
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert f"[profile] torch.profiler trace written to {traces[0]}" in log
    events = json.loads(traces[0].read_text())["traceEvents"]
    ops = [e for e in events if e.get("name", "").startswith("aten::")]
    assert ops
    assert profiled.read_bytes() == plain.read_bytes()
    assert _rays(log) == _rays(plain_log)
    # the program's spans, on the trace's clock: the frame holds the ops
    spans = [e for e in events if e.get("cat") == "program_span"]
    (frame,) = [e for e in spans if e["name"] == "frame"]
    waves = [e for e in spans if e["name"] == "wave"]
    assert len(waves) >= 2          # the scene samples 2 to 4 a pixel
    assert frame["ts"] <= min(w["ts"] for w in waves)
    inside = [e for e in ops if frame["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= frame["ts"] + frame["dur"]]
    assert len(inside) > len(ops) // 2
    # the table: each span's count and self time; the CPU has no device
    # events to put idle gaps down to
    rows = dict(re.findall(
        r"\[profile\] (\S+(?:, \S+)?) +(\d+) +[\d.]+ +[\d.]+\n", log))
    assert rows["frame"] == "1" and rows["wave"] == str(len(waves))
    # the scene's spheres and cone take the staged wave, op by op on the
    # CPU, and every closest hit and shadow ray of it the analytic passes
    assert rows["wave.trace[staged, eager]"] == rows["wave"]
    assert int(rows["trace.analytic"]) > 0
    # an adaptive frame's wave sets up twice: its active blocks, its
    # inputs; on the CPU by torch code
    assert rows["wave.inputs[torch]"] == str(2 * len(waves))
    assert "wave.inputs[kernel]" not in rows
    # the photon pass before the frame: its rounds, by route, and its ops
    assert rows["photons"] == "1"
    assert int(rows["photons.round[staged]"]) > 0
    (pas,) = [e for e in spans if e["name"] == "photons"]
    assert pas["ts"] + pas["dur"] <= frame["ts"]
    assert any(pas["ts"] <= e["ts"] <= pas["ts"] + pas["dur"] for e in ops)
    assert "[profile] device idle by span: no device events" in log


def _option_strings(main, name, capsys):
    """The option strings ``main([name, ..., "--help"])`` lists."""
    with pytest.raises(SystemExit) as done:
        main([name, "x", "--help"])
    assert done.value.code == 0
    opts = set()
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("  -"):          # an option's invocation
            invocation = line.strip().split("  ")[0]
            opts |= {part.split()[0] for part in invocation.split(", ")}
    return opts


@pytest.mark.parametrize("name", ["render", "photons", "bench",
                                  "grad-check"])
def test_cli_takes_the_jax_flags_plus_device(name, monkeypatch, capsys):
    # the JAX CLI's main turns on jax's persistent compilation cache
    # first; printing the help needs none of it
    monkeypatch.setattr(jax_cli, "_enable_compile_cache", lambda: None)
    want = _option_strings(jax_cli.main, name, capsys)
    assert {"-o", "--output", "--resume", "--profile", "-v"} <= want
    assert _option_strings(cli.main, name, capsys) == want | {"--device"}


_LAYOUTS = {
    # the events closed just before "traceName", the base time at the head
    "profiler": '{\n  "baseTimeNanoseconds": 1000,\n  "traceEvents": [\n'
                '  {"ph": "X", "name": "k", "ts": 1.0, "dur": 2}\n'
                '  ],"traceName": "a],b" }',
    # the logger's lists between them, the base time at the tail
    "kineto": '{\n  "traceEvents": [\n  {"ph": "X", "name": "k", "ts": 1.0,'
              ' "dur": 2, "args": {"grid": [1, 1, 1]}}\n  ],\n  "WARNING": '
              '["a}],b"],\n  "traceName": "t.json",\n  "baseTimeNanoseconds":'
              ' 1000\n}',
    # no event to close
    "other": json.dumps({"traceEvents": [], "baseTimeNanoseconds": 1000,
                         "traceName": "x"}),
}


@pytest.mark.parametrize("layout", ["profiler", "kineto", "other"])
def test_profile_adds_spans_to_a_trace(tmp_path, monkeypatch, layout):
    """``--profile`` puts the spans in the profiler's trace on its clock,
    in place before the bracket that closes its events (the file is not
    read whole), in the layouts torch's versions write; a trace with no
    such close is left as it was, and the call says so."""
    from gi_raytracer_tpu_torch import telemetry
    spans = [telemetry.Span("frame", 5_000, 9_000, 0, None, 0, {})]
    path = tmp_path / "t.pt.trace.json"
    text = _LAYOUTS[layout]
    path.write_text(text)
    monkeypatch.setattr(json, "load", None)     # never read whole
    added = cli._add_spans(str(path), spans)
    monkeypatch.undo()
    assert added == (layout != "other")
    trace = json.loads(path.read_text())
    if not added:
        assert path.read_text() == text
        return
    frame = [e for e in trace["traceEvents"] if e.get("name") == "frame"]
    assert len(frame) == 1 and frame[0]["ts"] == 4.0
    assert len(trace["traceEvents"]) == 3
    assert {k: v for k, v in trace.items() if k != "traceEvents"} == {
        k: v for k, v in json.loads(text).items() if k != "traceEvents"}
