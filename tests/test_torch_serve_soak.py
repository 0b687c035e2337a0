"""The JAX package's residency soak (``tests/test_serve_soak.py``) on the
port's resident server, through ``chip_smoke.py``'s soak (``python3
chip_smoke.py --only soak`` on a card runs it at the CLI's defaults over
100 tickets, the whole script over 40).  Here, on the CPU:

- tier 1: ``soak_run`` over 16 tickets of the JAX test's mix (a missing
  slide, a corrupt ticket and a duplicate patient among them) in 4 waves,
  on the JAX test's own slide pool, with the one-fold pipe of
  ``test_torch_serve.py`` and the stub detector: the spool, the status
  stream, per-shape caches, fds, threads, batches and repeat tickets
  held, and the spool and status stream equal to the JAX package's
  server's over the same tickets;
- the repeat-ticket comparison of ``serve_phase`` catching a changed
  merged row, per-crop file or overlay;
- the re-exec keeping what the server printed before it, and the
  harness's re-exec child (a stand-in server) checked against the soak's
  output and stopped when a phase fails; the soak's worker process
  writing its lines to its log;
- ``-m slow``: the 40-ticket twin of ``test_serve_soak_resources_plateau``
  with its numbers unchanged, on seeded weights.
"""
import collections
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench_soak  # noqa: E402
import chip_smoke  # noqa: E402
from glomeruli_segmentation_tpu.pipeline import serve as jax_serve  # noqa: E402
from glomeruli_segmentation_tpu.wsi import synthetic as jax_synthetic  # noqa: E402
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (  # noqa: E402
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e  # noqa: E402
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused  # noqa: E402
from glomeruli_segmentation_tpu_torch.pipeline import serve as port_serve  # noqa: E402

from test_serve_soak import _make_varied_slides  # noqa: E402
from test_torch_serve import _StubPipe, pipes  # noqa: E402,F401

TICKETS = 16
# test_serve_soak.py:98-131's rule, written out for 16 tickets: kind 5 a
# missing slide, 6 a corrupt ticket, 7 a duplicate of the first patient
WANT = (["done"] * 4 + ["failed", "failed", "skipped_already_done"]
        + ["done"] * 5 + ["failed", "failed", "skipped_already_done",
                          "done"])


@pytest.fixture(scope="module")
def soak_slides(tmp_path_factory):
    return _make_varied_slides(tmp_path_factory.mktemp("soak"))


def _missing(slides):
    """The missing slide of both servers' tickets."""
    return slides[0].parent.parent / "missing.tiff"


def _server(cls, pipe, root):
    out = root / "served"
    return cls(pipe, str(root / "spool"), str(out), json_dir=str(out / "json"),
               poll_interval=0.05, wave_size=4)


def _counted(obj, name, calls):
    fn = getattr(obj, name)

    def counted(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)

    setattr(obj, name, counted)


@pytest.fixture(scope="module")
def port_soak(pipes, soak_slides, tmp_path_factory):  # noqa: F811
    """The port's server through the soak, with its detector and
    ensemble batches counted."""
    pipe = pipes["port"]
    root = tmp_path_factory.mktemp("port_soak")
    calls = collections.Counter()
    ensemble = pipe.segmenter.ensemble
    batch_fns = [n for n in dir(ensemble) if n.startswith("submit_batch")]
    for name in batch_fns:
        _counted(ensemble, name, calls)
    _counted(pipe.backend, "detect_batch", calls)
    try:
        server = _server(port_serve.SlideServer, pipe, root)
        r = chip_smoke.soak_run(server, soak_slides, TICKETS,
                                _missing(soak_slides), device="cpu")
    finally:
        for name in batch_fns + ["detect_batch"]:
            obj = pipe.backend if name == "detect_batch" else ensemble
            delattr(obj, name)
    o = chip_smoke.soak_outcome(server, r)
    return {"server": server, "r": r, "o": o, "calls": calls}


@pytest.fixture(scope="module")
def jax_soak(pipes, soak_slides, tmp_path_factory, port_soak):  # noqa: F811
    """The JAX package's server over the same tickets, after the port's."""
    root = tmp_path_factory.mktemp("jax_soak")
    server = _server(jax_serve.SlideServer, pipes["jax"], root)
    r = chip_smoke.soak_run(server, soak_slides, TICKETS,
                            _missing(soak_slides), device="cpu")
    return {"server": server, "r": r}


def _trail(server):
    """The spool's listing and the status stream, in order, times left
    out."""
    spool = pathlib.Path(server.spool_dir)
    rows = (pathlib.Path(server.output_dir) / "serve_log.jsonl") \
        .read_text().splitlines()
    statuses = [{k: v for k, v in json.loads(ln).items()
                 if k not in ("ts", "sec")} for ln in rows]
    return ({d: sorted(os.listdir(spool / d))
             for d in ("active", "done", "failed")}, statuses)


def test_soak_mix_is_the_jax_tests(port_soak):
    r = port_soak["r"]
    assert [status for _, status, _, _ in r["tickets"]] == WANT
    assert len(r["samples"]) == TICKETS // 4
    assert [s["tickets"] for s in r["samples"]] == [4, 8, 12, 16]


def test_soak_spool_and_status_stream_equal_the_jax_servers(port_soak,
                                                           jax_soak):
    got, want = _trail(port_soak["server"]), _trail(jax_soak["server"])
    assert got == want
    listing, rows = got
    assert [r["ticket"] for r in rows if r["status"] == "failed"] == \
        ["job006.json", "job005.json", "job014.json", "job013.json"]
    assert rows[4]["error"].startswith("JSONDecodeError")
    assert listing["failed"] == ["job005.json", "job006.json",
                                 "job013.json", "job014.json"]


@pytest.mark.parametrize("bar", ["spool", "status stream", "caches", "fds",
                                 "threads", "launches", "repeat tickets"])
def test_soak_bars_hold_on_the_port(port_soak, bar):
    bars = {name: (ok, detail) for name, ok, detail in chip_smoke.soak_bars(
        port_soak["r"], port_soak["o"], "cpu", rss=False)}
    assert set(bars) == {"spool", "status stream", "caches", "fds",
                         "threads", "launches", "repeat tickets"}
    assert bars[bar][0], bars[bar][1]


def test_soak_batches_are_what_the_servers_ran(port_soak):
    """The launch bar's batches of each wave (crops over the ensemble's
    batch, windows over the detector's) against the batches the pipe
    ran."""
    o, calls = port_soak["o"], port_soak["calls"]
    crop_batches = sum(c for c, _ in o["batches"])
    window_batches = sum(w for _, w in o["batches"])
    assert crop_batches > 0 and window_batches > 0
    assert sum(v for k, v in calls.items() if k.startswith("submit_batch")) \
        == crop_batches
    assert calls["detect_batch"] == window_batches
    assert len(o["repeats"]) == 4


def test_soak_readings_and_verdict(port_soak):
    r, o = port_soak["r"], port_soak["o"]
    for s in r["samples"]:
        assert s["rss_kb"] > 0 and s["fds"] > 0 and s["tasks"] >= 1
        assert s["caches"] == {"detector _geometry": 0}
        assert s["launches"] == (0, 0, 0)
        assert "allocated" not in s
        # glibc's C heap: bytes in use, free and mapped
        assert s["heap"] is not None and s["heap"][0] > 0
    bars = chip_smoke.soak_bars(r, o, "cpu", rss=False)
    verdict = chip_smoke.soak_verdict(r, o, bars, "cpu")
    assert verdict["tickets"] == TICKETS and verdict["ok"]
    assert verdict["statuses"] == {"done": 10, "failed": 4,
                                   "skipped_already_done": 2}
    assert verdict["cache_entries_added_second_half"] == 0


@pytest.mark.parametrize("change", ["merged row", "per-crop file",
                                    "overlay"])
def test_repeat_ticket_comparison_catches_a_change(port_soak, tmp_path,
                                                   change):
    """``serve_phase``'s comparison of two patients on one slide: equal on
    the soak's output, and a changed byte in any artifact shows."""
    server = port_soak["server"]
    patient, earlier, diffs = port_soak["o"]["repeats"][0]
    assert diffs == []
    out = tmp_path / "served"
    shutil.copytree(server.output_dir, out)
    assert chip_smoke.repeat_ticket_diffs(out, out / "json", "OPT_PAS",
                                          patient, earlier) == []
    if change == "merged row":
        csv = out / "OPT_PAS_GlomusMergedList_.csv"
        rows = csv.read_text().splitlines(True)
        i = next(i for i, r in enumerate(rows)
                 if r.split(",")[1] == patient)
        cells = rows[i].split(",")
        cells[3] = str(int(cells[3]) + 1)
        rows[i] = ",".join(cells)
        csv.write_text("".join(rows))
    elif change == "per-crop file":
        name = sorted(os.listdir(out / "json" / patient))[0]
        path = out / "json" / patient / name
        path.write_bytes(path.read_bytes().replace(b"]", b" ]", 1))
    else:
        path = out / f"{patient}_pred.jpg"
        data = bytearray(path.read_bytes())
        data[-3] ^= 1
        path.write_bytes(bytes(data))
    diffs = chip_smoke.repeat_ticket_diffs(out, out / "json", "OPT_PAS",
                                           patient, earlier)
    assert len(diffs) == 1 and patient in diffs[0]


def test_soak_slide_pool_is_bench_soaks(tmp_path):
    """The pool's recipe is ``bench_soak.py``'s (sizes, seeds, glomeruli,
    0.23 um/px, 4 levels), and a slide written by the port's writer equals
    the JAX package's, byte for byte (checked at a small size)."""
    assert chip_smoke.SOAK_DIMS == tuple(bench_soak.DIMS)
    assert chip_smoke.SOAK_POOL == [
        (h, w, 500 + i, 6 + 2 * (i % 3))
        for i, (h, w) in enumerate(bench_soak.DIMS)]
    got = chip_smoke.soak_write_slide(tmp_path / "port.tiff", 384, 512,
                                      503, 6)
    img, _ = jax_synthetic.pas_like_image(384, 512, seed=503,
                                          n_glomeruli=6)
    jax_synthetic.write_pyramidal_tiff(str(tmp_path / "jax.tiff"), img,
                                       mpp=0.23, objective_power=40.0,
                                       levels=4)
    assert got.read_bytes() == (tmp_path / "jax.tiff").read_bytes()


def test_reexec_keeps_what_the_server_printed(tmp_path):
    """``execv`` drops what Python still buffers: a server whose output
    is piped to a supervisor must flush before it re-execs, or its last
    lines (``served N ticket(s)``) are lost."""
    code = ("from glomeruli_segmentation_tpu_torch.cli import serve\n"
            "print('served 4 ticket(s)')\n"
            "serve._reexec(['--help'])\n")
    env = dict(os.environ)
    env.pop("PYTHONUNBUFFERED", None)
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    lines = done.stdout.splitlines()
    assert lines[0] == "served 4 ticket(s)"
    assert any(ln.startswith("usage:") for ln in lines)


@pytest.mark.slow
def test_serve_soak_resources_plateau_on_the_port(tmp_path):
    """``test_serve_soak_resources_plateau`` on the port, numbers unchanged:
    40 tickets in waves of 4 over the JAX test's slides, two seeded folds
    at the reference widths (batch 2, f32, highest), its blob detector and
    geometry; the spool, the status stream, per-shape caches (none added
    in the second half, fewer than 40), fd drift <= 4, RSS <= 1.05 x two
    waves earlier and <= 1.10 x at half-time; threads and repeat tickets
    too."""
    from test_detect_stage import BlobBackend

    slides = _make_varied_slides(tmp_path)
    ckpts = []
    for fold in (1, 2):
        path = tmp_path / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, 5, p=2, q=8), path)
        ckpts.append(str(path))
    ensemble = port_fused.EnsembleSegmenter(port_fused.EnsembleConfig(
        checkpoints=ckpts, folds=(1, 2), batch_size=2,
        compute_dtype="float32", precision="highest"), device="cpu")
    pipe = port_e2e.FusedEndToEnd(BlobBackend(), ensemble, window_size=100,
                                  overlap_ratio=0.5, detect_conf=0.5,
                                  merge_conf=0.9, merge_overlap=0.35)
    server = _server(port_serve.SlideServer, pipe, tmp_path)
    r = chip_smoke.soak_run(server, slides, 40, tmp_path / "missing.tiff",
                            device="cpu")
    o = chip_smoke.soak_outcome(server, r)
    bars = chip_smoke.soak_bars(r, o, "cpu")
    assert {name for name, _, _ in bars} >= {"spool", "status stream",
                                              "caches", "fds", "RSS"}
    missed = [(name, detail) for name, ok, detail in bars if not ok]
    assert not missed, missed
    assert o["statuses"] == {"done": 25, "failed": 10,
                             "skipped_already_done": 5}


# ---------------- the re-exec's child and the soak's worker ----------------
FAKE_SERVE = '''\
import argparse, json, os, shutil, sys, time
p = argparse.ArgumentParser()
for flag in ("--spool_dir", "--output_dir", "--recycle_rss_mb"):
    p.add_argument(flag)
p.add_argument("--max_slides", type=int)
args, _ = p.parse_known_args()
mode = os.environ["FAKE_SERVE"]
spool, out = args.spool_dir, args.output_dir
for d in ("active", "done", "failed"):
    os.makedirs(os.path.join(spool, d), exist_ok=True)
os.makedirs(out, exist_ok=True)
print("serving " + spool, flush=True)
if mode == "hang":
    time.sleep(600)
for name in sorted(f for f in os.listdir(spool) if f.endswith(".json"))[:4]:
    patient = json.load(open(os.path.join(spool, name)))["patient_id"]
    with open(os.path.join(out, "OPT_PAS_GlomusMergedList_.csv"), "a") as f:
        f.write("0," + patient + ",1,2,3,4\\n")
    os.makedirs(os.path.join(out, "json", patient))
    with open(os.path.join(out, "json", patient, "a.json"), "w") as f:
        f.write("crop" if mode == "ok" else "changed")
    with open(os.path.join(out, patient + "_pred.jpg"), "w") as f:
        f.write("overlay")
    shutil.move(os.path.join(spool, name), os.path.join(spool, "done", name))
print("served 4 ticket(s)")
if args.max_slides == 8:
    print("RSS above 1 MB: recycling")
    sys.stdout.flush()
    argv = sys.argv[1:]
    argv[argv.index("--max_slides") + 1] = "4"
    os.execv(sys.executable, [sys.executable, sys.argv[0]] + argv)
'''


@pytest.fixture
def fake_serve(tmp_path, monkeypatch):
    """``python -m ...cli.serve`` replaced by a script that serves the
    spool's tickets four at a time, writing one merged row, one per-crop
    file and an overlay per ticket, and re-execs itself as the server
    does; and the in-process soak's output it is held to."""
    script = tmp_path / "fake_serve.py"
    script.write_text(FAKE_SERVE)
    python = tmp_path / "python"
    python.write_text(f"#!/bin/sh\nshift 2\nexec {sys.executable} "
                      f"{script} \"$@\"\n")
    python.chmod(0o755)
    monkeypatch.setattr(sys, "executable", str(python))
    ref = tmp_path / "soak_out"
    (ref / "json" / "SOAK-011").mkdir(parents=True)
    (ref / "json" / "SOAK-011" / "a.json").write_text("crop")
    (ref / "SOAK-011_pred.jpg").write_text("overlay")
    (ref / "OPT_PAS_GlomusMergedList_.csv").write_text(
        "0,SOAK-009,1,2,3,5\n0,SOAK-011,1,2,3,4\n")
    slides = [tmp_path / f"s{i}.tiff" for i in range(6)]
    soak = {"out": str(ref), "json_dir": str(ref / "json"),
            "references": {str(slides[chip_smoke.SOAK_REEXEC_SLIDE]):
                           "SOAK-011"}}
    return slides, soak


def test_reexec_child_is_checked_against_the_soaks_output(
        fake_serve, tmp_path, monkeypatch, capsys):
    slides, soak = fake_serve
    monkeypatch.setenv("FAKE_SERVE", "ok")
    run = chip_smoke.reexec_start(["--model", "m"], tmp_path / "re", slides)
    r = chip_smoke.reexec_finish(run, soak, "card")
    assert 0 < r["restart"] < r["wall"]
    assert not any(t.is_alive() for t in run["readers"])
    assert sorted(os.listdir(tmp_path / "re" / "spool" / "done")) == [
        f"re{i:02d}.json" for i in range(1, 9)]
    line = capsys.readouterr().out
    assert "exit 0 in" in line and "no nvcc" in line


def test_reexec_child_whose_artifacts_differ_fails(fake_serve, tmp_path,
                                                   monkeypatch):
    slides, soak = fake_serve
    monkeypatch.setenv("FAKE_SERVE", "changed")
    run = chip_smoke.reexec_start(["--model", "m"], tmp_path / "re", slides)
    with pytest.raises(RuntimeError, match="per-crop files"):
        chip_smoke.reexec_finish(run, soak, "card")


def test_reexec_stop_ends_a_child_still_running(fake_serve, tmp_path,
                                                monkeypatch):
    """A phase that fails beside the re-exec stops its child."""
    slides, _ = fake_serve
    monkeypatch.setenv("FAKE_SERVE", "hang")
    run = chip_smoke.reexec_start(["--model", "m"], tmp_path / "re", slides)
    chip_smoke.reexec_stop(run)
    assert run["proc"].returncode is not None
    assert not any(t.is_alive() for t in run["readers"])


def test_soak_worker_writes_its_lines_to_its_log(tmp_path, monkeypatch):
    """The whole script's soak, in a process of its own: the soak's lines
    go to its log (printed by the parent when it is done), its result
    comes back."""
    got = {}

    def soak_serve(ckpt_dir, model_dir, slides, name_power, tickets):
        got.update(args=(ckpt_dir, model_dir, slides, tickets))
        print("soak wave 1")
        return {"launches": (40, 0, 2)}

    monkeypatch.setattr(chip_smoke, "soak_serve", soak_serve)
    log = tmp_path / "soak.log"
    r = chip_smoke.soak_worker("folds", "model", ["s0.tiff"], "card",
                               str(log))
    assert r == {"launches": (40, 0, 2)}
    assert got["args"] == (pathlib.Path("folds"), pathlib.Path("model"),
                           [pathlib.Path("s0.tiff")], chip_smoke.SOAK_TICKETS)
    assert log.read_text() == "soak wave 1\n"
