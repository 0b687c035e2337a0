"""The port's resident slide server (``pipeline/serve.py`` ``SlideServer``
and ``cli/serve.py``) against the JAX package's on the CPU: the spool
mechanics over a stub pipe, the parser, the recycle bound and re-exec, and
both packages' servers over small real pipelines that share one stub
detector backend, pipelined and serial."""
import json
import os
import sys

import pytest
import torch

from glomeruli_segmentation_tpu.cli import serve as jax_cli_serve
from glomeruli_segmentation_tpu.pipeline import e2e as jax_e2e
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.pipeline import serve as jax_serve
from glomeruli_segmentation_tpu_torch.cli import serve as cli_serve
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused
from glomeruli_segmentation_tpu_torch.pipeline import serve as port_serve

from test_torch_e2e import (StubBackend, assert_same_artifacts, crop_files,
                            write_slide)

SERVERS = {"port": port_serve.SlideServer, "jax": jax_serve.SlideServer}


def _drop_ticket(spool, name, slide_path, patient_id, mtime=None):
    os.makedirs(spool, exist_ok=True)
    path = os.path.join(spool, name)
    with open(path, "w") as f:
        json.dump({"slide_path": str(slide_path),
                   "patient_id": patient_id}, f)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def _spool_state(spool):
    """{subdirectory: {ticket name: parsed contents}} of a spool."""
    return {sub: {name: json.loads((spool / sub / name).read_text())
                  for name in sorted(os.listdir(spool / sub))}
            for sub in ("active", "done", "failed")}


def _rows(out):
    return [json.loads(line)
            for line in (out / "serve_log.jsonl").read_text().splitlines()]


class _StubPipe:
    """Spool-mechanics-only stand-in (no model, no slide IO)."""
    data_category = "OPT_PAS"

    def run_slide(self, slide_path, output_dir, patient_id, json_dir=None,
                  write_overlay=True):
        return None


def _multi_server(server_cls, root):
    """The JAX package's shared-spool scenario (its ``test_serve.py``):
    namespaced claims, a lost claim race, recovery of a server's own stale
    claims only.  Returns what it observed."""
    spool = root / "spool"
    out_a, out_b = root / "a", root / "b"
    os.makedirs(spool)
    seen = []
    a = server_cls(_StubPipe(), str(spool), str(out_a), server_id="hostA")
    b = server_cls(_StubPipe(), str(spool), str(out_b), server_id="hostB")
    _drop_ticket(str(spool), "t1.json", "/nonexistent.tif", "P1")
    path = os.path.join(str(spool), "t1.json")
    os.replace(path, os.path.join(a.active_dir, "hostA__t1.json"))
    seen.append(b.process_ticket(path))
    b2 = server_cls(_StubPipe(), str(spool), str(out_b), server_id="hostB")
    seen.append((_spool_state(spool), b2.scan()))
    a2 = server_cls(_StubPipe(), str(spool), str(out_a), server_id="hostA")
    seen.append(a2.scan() == [path])
    row = a2.process_ticket(path)
    seen.append({k: v for k, v in row.items() if k not in ("ts", "sec")})
    seen.append(_spool_state(spool))
    with pytest.raises(ValueError):
        server_cls(_StubPipe(), str(spool), str(out_a), server_id="x__y")
    return seen


def test_multi_server_shared_spool_matches_jax(tmp_path):
    got = {name: _multi_server(cls, tmp_path / name)
           for name, cls in SERVERS.items()}
    assert got["port"] == got["jax"]
    lost, (mid_state, b_scan), recovered, row, final = got["port"]
    assert lost is None and b_scan == []
    assert list(mid_state["active"]) == ["hostA__t1.json"]
    assert recovered and row["status"] == "done"
    assert list(final["done"]) == ["t1.json"] and not final["active"]


def test_serve_parser_surface_matches_jax():
    """Every option of the JAX serve parser, with its default, and no
    other; the batch-run inputs are refused."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
                for a in parser._actions}

    assert options(cli_serve.build_parser()) == \
        options(jax_cli_serve.build_parser())
    parser = cli_serve.build_parser()
    args = parser.parse_args([
        "--model", "/m", "--segmentation_weights_dir", "/w",
        "--spool_dir", "/spool", "--output_dir", "/out",
        "--max_slides", "3", "--no_overlay"])
    assert args.spool_dir == "/spool" and args.max_slides == 3
    assert args.engine == "auto" and args.no_overlay
    assert args.recycle_rss_mb is None and args.poll_interval == 2.0
    for flag in ("--target_list", "--data_dir", "--resume"):
        with pytest.raises(SystemExit):
            parser.parse_args(["--model", "/m", "--spool_dir", "/s", flag]
                              + ([] if flag == "--resume" else ["/t"]))


def test_recycle_bound_and_restart(tmp_path):
    """Over the port's server, as the JAX package's test holds its own:
    past the RSS bound ``serve`` returns with ``recycle_requested`` but
    never before the first ticket, and fresh servers drain the spool."""
    spool, out = tmp_path / "spool", tmp_path / "out"
    os.makedirs(spool)
    for i in range(3):
        _drop_ticket(str(spool), f"t{i}.json", f"/s{i}.tif", f"P{i}")
    server = port_serve.SlideServer(_StubPipe(), str(spool), str(out),
                                    recycle_rss_mb=1)
    n = server.serve(max_slides=3)
    assert n >= 1 and server.recycle_requested
    assert len([f for f in os.listdir(spool) if f.endswith(".json")]) == 3 - n
    total = n
    while total < 3:
        s = port_serve.SlideServer(_StubPipe(), str(spool), str(out),
                                   recycle_rss_mb=1)
        got = s.serve(max_slides=3 - total)
        assert got >= 1
        total += got
    assert total == 3
    _drop_ticket(str(spool), "t9.json", "/s9.tif", "P9")
    roomy = port_serve.SlideServer(_StubPipe(), str(spool), str(out),
                                   recycle_rss_mb=10**6)
    assert roomy.serve(max_slides=1) == 1 and not roomy.recycle_requested
    assert port_serve._rss_kb() > 0


@pytest.mark.parametrize("argv,remaining", [
    (["--model", "/m", "--max_slides", "10", "--spool_dir", "/s"], 7),
    (["--max_slides=10", "--spool_dir", "/s"], 3),
    (["--spool_dir", "/s"], 2),
])
def test_argv_with_max_slides_matches_jax(argv, remaining):
    got = cli_serve._argv_with_max_slides(argv, remaining)
    assert got == jax_cli_serve._argv_with_max_slides(argv, remaining)
    assert got[-2:] == ["--max_slides", str(remaining)]
    assert got.count("--max_slides") == 1


def test_reexec_runs_the_port_module(monkeypatch):
    calls = []
    monkeypatch.setattr(os, "execv", lambda *a: calls.append(a))
    cli_serve._reexec(["--spool_dir", "/s", "--max_slides", "2"])
    assert calls == [(sys.executable, [
        sys.executable, "-m", "glomeruli_segmentation_tpu_torch.cli.serve",
        "--spool_dir", "/s", "--max_slides", "2"])]


def test_stop_file_and_stale_claim_recovery(tmp_path):
    """The stop file ends ``serve`` before any ticket; a legacy
    un-namespaced claim left in ``active/`` goes back into the spool, a
    peer's stays."""
    spool, out = tmp_path / "spool", tmp_path / "out"
    os.makedirs(spool / "active")
    (spool / "STOP").touch()
    _drop_ticket(str(spool), "waiting.json", "/w.tif", "W")
    assert port_serve.SlideServer(_StubPipe(), str(spool),
                                  str(out)).serve() == 0
    assert (spool / "waiting.json").is_file()
    for name in ("stale.json", "peer__busy.json"):
        (spool / "active" / name).write_text('{"slide_path": "/nope"}')
    server = port_serve.SlideServer(_StubPipe(), str(spool), str(out),
                                    server_id="me")
    assert (spool / "stale.json").is_file()
    assert os.listdir(spool / "active") == ["peer__busy.json"]
    assert server.scan() == sorted(server.scan(), key=lambda p: (
        os.stat(p).st_mtime, os.path.basename(p)))
    assert set(server.scan()) == {str(spool / "stale.json"),
                                  str(spool / "waiting.json")}


def test_serve_main_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """``main`` loads the detector for the card unless told otherwise, and
    without a card that load raises instead of running on the CPU."""
    from glomeruli_segmentation_tpu_torch.cli import detect as cli_detect

    asked = []

    def load_backend(*args, device, **kw):
        asked.append(device)
        return load(*args, device=device, **kw)

    load = cli_detect.load_backend
    monkeypatch.setattr(cli_detect, "load_backend", load_backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "model").mkdir()
    torch.save({"od_api_params": {}, "num_classes": 1, "od_config": {}},
               tmp_path / "model" / "od_api_detector.ckpt.pth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["--model", str(tmp_path / "model"),
                        "--segmentation_weights_dir", str(tmp_path),
                        "--spool_dir", str(tmp_path / "spool")])
    assert asked == ["cuda"]


# ---- both packages' servers over small real pipelines ----
SMALL = dict(folds=(1,), p=1, q=2, in_height=64, in_width=128, batch_size=2,
             compute_dtype="float32", precision="highest")
GEOMETRY = dict(window_size=64, overlap_ratio=0.5, detect_conf=0.5,
                merge_conf=0.9, merge_overlap=0.35)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """(port, JAX) ``FusedEndToEnd``s: one fold (p=1, q=2, 64x128) in the
    packed engine, one shared stub detector backend."""
    d = tmp_path_factory.mktemp("serve_fold")
    ckpt = str(d / "espnet_fold1.pth")
    torch.save(random_state_dict(1, 5, p=1, q=2), ckpt)
    backend = StubBackend()
    port = port_e2e.FusedEndToEnd(backend, port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=[ckpt], **SMALL),
        engine="packed", device="cpu"), **GEOMETRY)
    jax = jax_e2e.FusedEndToEnd(backend, jax_fused.EnsembleSegmenter(
        jax_fused.EnsembleConfig(checkpoints=[ckpt], **SMALL),
        engine="packed"), **GEOMETRY)
    return {"port": port, "jax": jax}


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_slides")
    return [write_slide(d / f"S{i}.tiff", seed=70 + i) for i in range(2)]


@pytest.mark.parametrize("pipeline", [True, False])
def test_servers_over_real_pipelines_match_jax(pipes, slides, tmp_path,
                                               pipeline):
    """Tickets: two patients, a second ticket for the first inside the same
    wave, and a missing slide.  Both servers leave the same ``done/``,
    ``failed/`` and ``active/``, the same ``serve_log.jsonl`` rows (times
    aside) and byte-identical artifacts."""
    tickets = [("job1.json", slides[0], "P1"), ("job2.json", slides[1], "P2"),
               ("job3.json", slides[0], "P1"),
               ("job4.json", tmp_path / "missing.tiff", "GHOST")]
    got = {}
    for name, pipe in pipes.items():
        root = tmp_path / name
        for i, (ticket, path, pid) in enumerate(tickets):
            _drop_ticket(str(root / "spool"), ticket, path, pid,
                         mtime=1.7e9 + i)
        out = root / "out"
        server = SERVERS[name](pipe, str(root / "spool"), str(out),
                               json_dir=str(out / "json"),
                               poll_interval=0.01, pipeline=pipeline)
        assert server.serve(max_slides=4) == 4
        rows = [{k: v for k, v in r.items() if k not in ("ts", "sec")}
                for r in _rows(out)]
        got[name] = (_spool_state(root / "spool"), rows)
    assert got["port"] == got["jax"]
    state, rows = got["port"]
    assert list(state["done"]) == ["job1.json", "job2.json", "job3.json"]
    assert list(state["failed"]) == ["job4.json"] and not state["active"]
    assert "error" in state["failed"]["job4.json"]
    want = (["done", "done", "failed", "skipped_already_done"] if pipeline
            else ["done", "done", "skipped_already_done", "failed"])
    assert [r["status"] for r in rows] == want
    assert state["failed"]["job4.json"]["error"].startswith(
        "FileNotFoundError")
    port_out = tmp_path / "port" / "out"
    assert all(crop_files(port_out, pid) for pid in ("P1", "P2"))
    assert_same_artifacts(port_out, tmp_path / "jax" / "out", ["P1", "P2"])
