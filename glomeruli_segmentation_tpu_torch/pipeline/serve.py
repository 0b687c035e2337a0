"""Resident slide-serving loop on the GPU: one process, the models stay
loaded on the card.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/serve.py``.  The
reference pipeline is batch scripts chained by hand
(``example/README.md:27-133``): every invocation pays process start, CUDA
start and model load before the first window runs.  The server keeps ONE
resident process with the detector and the fold ensemble on the card, and
feeds it work through a spool directory of job tickets -- the reference's
files-as-API convention lifted from the stage level to the job level.

Ticket contract: ``<name>.json`` dropped into the spool dir::

    {"slide_path": "/abs/path/PAS-001.ndpi", "patient_id": "PAS-001"}

Tickets are processed in (mtime, name) order.  A ticket is *claimed* by
moving it to ``spool/active/`` (so a crash leaves the in-flight job
visible; stale claims are recovered back into the spool on startup),
then moved to ``spool/done/`` on success or ``spool/failed/`` (with an
``"error"`` field added) on failure -- a failing slide never takes the
server down.  Per slide the artifacts are exactly ``gseg-e2e``'s: the
accumulated merged-detection CSV, per-crop labelme JSONs, the stitched
``{patient}_pred.jpg`` and the timing log
(merge_overlaped_glomus.py:102-124, VisualizeResults_iou.py:161-182,
eval_wsi_segmentation.py:359-394, detect_glomus_test.py:110-112).
A JSONL status stream (``serve_log.jsonl`` in the output dir) records
one row per ticket for monitoring.

Shutdown: touch the stop file (default ``<spool>/STOP``); the server
finishes the wave in flight and exits.

Multi-server: several servers (e.g. one per card) may share one spool for
scale-out.  Claims are namespaced ``<server_id>__<name>`` (default id:
hostname) so a restarting server recovers only *its own* stale claims,
never a peer's in-flight ticket; the claim rename is atomic, and losing
the race to a peer just skips the ticket.  Point each server at its own
``--output_dir`` (the merged CSV / timing log are per-run artifact
streams); the spool's done/failed lifecycle is the cross-server dedupe.
"""
from __future__ import annotations

import datetime
import json
import os
import time
import traceback
from typing import List, Optional

from .e2e import FusedEndToEnd


def _rss_kb() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:  # pragma: no cover - non-Linux
        pass
    return 0


class SlideServer:
    """Watch a spool directory and run each ticket through a resident
    :class:`.e2e.FusedEndToEnd`."""

    def __init__(self, pipe: FusedEndToEnd, spool_dir: str, output_dir: str,
                 json_dir: Optional[str] = None, write_overlay: bool = True,
                 poll_interval: float = 2.0,
                 stop_file: Optional[str] = None,
                 server_id: Optional[str] = None,
                 pipeline: bool = True, wave_size: int = 4,
                 recycle_rss_mb: Optional[int] = None):
        """``pipeline``: overlap ticket N+1's detection scan with ticket
        N's segmentation (``FusedEndToEnd.run_slides``).  Tickets are
        claimed in waves of up to ``wave_size`` so the STOP file and
        ``max_slides`` are honored between waves; a crash mid-wave leaves
        the unprocessed claims in ``active/`` for startup recovery.

        ``recycle_rss_mb``: bounded-memory residency -- when host RSS
        exceeds this between waves/tickets, :meth:`serve` returns early
        with :attr:`recycle_requested` set so the caller can restart the
        process cleanly (``cli/serve.py`` re-execs itself with the same
        argv).  Everything needed for a seamless restart is already
        durable: completedness is re-learned from the timing log, stale
        claims recover on startup, and the kernel libraries built into
        ``build/torch_kernels/`` are reused, so the new process pays CUDA
        start and model load only.  Motivation: classic resident-server
        process recycling -- host memory that grows outside the server's
        control (a library that keeps pinned staging buffers)
        is returned by a restart."""
        import socket

        # stable per-server-slot identity: a restart recovers its own
        # stale claims, never a live peer's (one server per host by
        # default; pass server_id to run several on one host)
        self.server_id = server_id or socket.gethostname()
        if "__" in self.server_id:
            raise ValueError("server_id must not contain '__' "
                             "(claim-name separator)")
        self.pipe = pipe
        self.pipeline = pipeline and hasattr(pipe, "run_slides")
        self.wave_size = max(1, wave_size)
        self.spool_dir = spool_dir
        self.output_dir = output_dir
        self.json_dir = json_dir
        self.write_overlay = write_overlay
        self.poll_interval = poll_interval
        self.stop_file = stop_file or os.path.join(spool_dir, "STOP")
        self.active_dir = os.path.join(spool_dir, "active")
        self.done_dir = os.path.join(spool_dir, "done")
        self.failed_dir = os.path.join(spool_dir, "failed")
        for d in (spool_dir, self.active_dir, self.done_dir,
                  self.failed_dir, output_dir):
            os.makedirs(d, exist_ok=True)
        self.recycle_rss_mb = recycle_rss_mb
        self.recycle_requested = False
        self.log_path = os.path.join(output_dir, "serve_log.jsonl")
        # accumulate across restarts: resume semantics give us the set of
        # slides whose artifacts are already complete (SURVEY.md §5.3)
        self.completed = FusedEndToEnd.prepare_output(
            output_dir, pipe.data_category, resume=True)
        self._recover_stale_claims()

    # -- spool mechanics ------------------------------------------------

    def _recover_stale_claims(self) -> None:
        """Move tickets a crashed run left in active/ back into the spool.

        Only claims bearing THIS server's id are recovered: in a shared
        spool, a peer's ``active/`` entries are its live in-flight work,
        and stealing them back would run the slide twice.  Legacy
        un-namespaced claims (pre-multi-server format) are also
        recovered -- only a dead run can have left those.
        """
        prefix = self.server_id + "__"
        for name in sorted(os.listdir(self.active_dir)):
            if not name.endswith(".json"):
                continue
            if name.startswith(prefix):
                original = name[len(prefix):]
            elif "__" not in name:
                original = name
            else:
                continue  # a peer's claim
            os.replace(os.path.join(self.active_dir, name),
                       os.path.join(self.spool_dir, original))

    def scan(self) -> List[str]:
        """Pending ticket paths in (mtime, name) order."""
        entries = []
        for entry in os.scandir(self.spool_dir):
            if entry.is_file() and entry.name.endswith(".json"):
                entries.append((entry.stat().st_mtime, entry.name))
        return [os.path.join(self.spool_dir, name)
                for _, name in sorted(entries)]

    def _log(self, row: dict) -> None:
        row["ts"] = datetime.datetime.today().strftime("%Y-%m-%dT%H:%M:%S")
        with open(self.log_path, "a") as f:
            f.write(json.dumps(row) + "\n")
            f.flush()

    # -- ticket processing ----------------------------------------------

    def process_ticket(self, path: str) -> Optional[dict]:
        """Claim and run one ticket; never raises.

        Returns None when a peer server claims the ticket first (the
        atomic rename fails with the source gone) -- not an error, just
        someone else's work now.
        """
        name = os.path.basename(path)
        claimed = os.path.join(self.active_dir,
                               f"{self.server_id}__{name}")
        try:
            os.replace(path, claimed)
        except FileNotFoundError:
            return None  # a peer won the claim race
        t0 = time.time()
        row = {"ticket": name}
        try:
            with open(claimed) as f:
                ticket = json.load(f)
            slide_path = ticket["slide_path"]
            patient_id = ticket.get(
                "patient_id",
                os.path.splitext(os.path.basename(slide_path))[0])
            row.update(patient_id=patient_id, slide_path=slide_path)
            if patient_id in self.completed:
                # artifacts already complete (timing-log row present);
                # re-running would duplicate the slide's merged-CSV rows
                row["status"] = "skipped_already_done"
                os.replace(claimed, os.path.join(self.done_dir, name))
                return row
            self.pipe.run_slide(slide_path, self.output_dir, patient_id,
                                json_dir=self.json_dir,
                                write_overlay=self.write_overlay)
            self.completed.add(patient_id)
            row.update(status="done", sec=round(time.time() - t0, 3))
            os.replace(claimed, os.path.join(self.done_dir, name))
        except Exception as exc:  # noqa: BLE001 -- a bad slide must not
            # take the resident server (and its warm programs) down
            row.update(status="failed", sec=round(time.time() - t0, 3),
                       error=f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            try:
                with open(claimed) as f:
                    ticket = json.load(f)
            except Exception:
                ticket = {}
            ticket["error"] = row["error"]
            failed = os.path.join(self.failed_dir, name)
            with open(failed, "w") as f:
                json.dump(ticket, f, indent=2)
            if os.path.isfile(claimed):
                os.remove(claimed)
        return row

    def _emit(self, row: dict) -> None:
        self._log(row)
        print(f"[{row.get('status')}] {row.get('patient_id', '?')}"
              + (f" ({row['sec']}s)" if "sec" in row else ""))

    def _process_wave(self, paths: List[str]) -> int:
        """Claim up to a wave of tickets and stream them through the
        cross-slide-pipelined runner: ticket N+1's detection scan + crop
        staging overlap ticket N's fused segmentation
        (``FusedEndToEnd.run_slides``).  Per-ticket lifecycle (claim ->
        done/failed, log row, failure isolation) is identical to
        :meth:`process_ticket`; rows are logged in ticket order.  Returns
        the number of tickets handled (incl. skips/failures)."""
        from collections import deque

        handled = 0
        wave = []  # (name, claimed, ticket, slide_path, patient_id, row)
        for path in paths:
            name = os.path.basename(path)
            claimed = os.path.join(self.active_dir,
                                   f"{self.server_id}__{name}")
            try:
                os.replace(path, claimed)
            except FileNotFoundError:
                continue  # a peer won the claim race
            row = {"ticket": name}
            try:
                with open(claimed) as f:
                    ticket = json.load(f)
                slide_path = ticket["slide_path"]
                patient_id = ticket.get(
                    "patient_id",
                    os.path.splitext(os.path.basename(slide_path))[0])
            except Exception as exc:  # unreadable ticket: file it failed
                row.update(status="failed",
                           error=f"{type(exc).__name__}: {exc}")
                with open(os.path.join(self.failed_dir, name), "w") as f:
                    json.dump({"error": row["error"]}, f, indent=2)
                if os.path.isfile(claimed):
                    os.remove(claimed)
                self._emit(row)
                handled += 1
                continue
            row.update(patient_id=patient_id, slide_path=slide_path)
            if patient_id in self.completed:
                row["status"] = "skipped_already_done"
                os.replace(claimed, os.path.join(self.done_dir, name))
                self._emit(row)
                handled += 1
                continue
            if any(pid == patient_id for _, _, _, _, pid, _ in wave):
                # a second ticket for the same patient inside one wave
                # would run the slide twice (the serial loop learned
                # completedness between tickets); defer it -- unclaim back
                # into the spool so the NEXT wave sees it and takes the
                # skip-already-done path
                os.replace(claimed, path)
                continue
            wave.append((name, claimed, ticket, slide_path, patient_id,
                         row))
        if not wave:
            return handled

        dq = deque(wave)

        def on_result(patient_id, slide_path, error, sec):
            nonlocal handled
            name, claimed, ticket, _, pid, row = dq.popleft()
            assert pid == patient_id, (pid, patient_id)
            row["sec"] = sec
            if error is None:
                self.completed.add(pid)
                row["status"] = "done"
                os.replace(claimed, os.path.join(self.done_dir, name))
            else:
                row.update(status="failed",
                           error=f"{type(error).__name__}: {error}")
                traceback.print_exception(type(error), error,
                                          error.__traceback__)
                ticket["error"] = row["error"]
                with open(os.path.join(self.failed_dir, name), "w") as f:
                    json.dump(ticket, f, indent=2)
                if os.path.isfile(claimed):
                    os.remove(claimed)
            self._emit(row)
            handled += 1

        self.pipe.run_slides(
            [(slide_path, pid) for _, _, _, slide_path, pid, _ in wave],
            self.output_dir, json_dir=self.json_dir,
            write_overlay=self.write_overlay, on_result=on_result,
            pipeline=self.pipeline)
        return handled

    # -- main loop -------------------------------------------------------

    def _needs_recycle(self) -> bool:
        """Between waves/tickets: request a clean process restart when
        host RSS crosses the configured bound (no in-flight work at the
        check points, so the restart is always crash-safe-by-design)."""
        if self.recycle_rss_mb is None or self.recycle_requested:
            return self.recycle_requested
        if _rss_kb() / 1024.0 > self.recycle_rss_mb:
            print(f"RSS above {self.recycle_rss_mb} MB; requesting "
                  "process recycle")
            self.recycle_requested = True
        return self.recycle_requested

    def serve(self, max_slides: Optional[int] = None) -> int:
        """Process tickets until the stop file appears (or ``max_slides``
        tickets have been handled, or the RSS recycle bound trips -- see
        :attr:`recycle_requested`).  Returns the number processed."""
        use_waves = hasattr(self.pipe, "run_slides")
        processed = 0
        while True:
            if os.path.exists(self.stop_file):
                print("stop file present; exiting")
                return processed
            # progress guarantee: a process whose BASELINE RSS already
            # exceeds the bound must still do at least one wave, or a
            # too-low bound would recycle forever without working
            if processed and self._needs_recycle():
                return processed
            pending = self.scan()
            if not pending:
                if max_slides is not None and processed >= max_slides:
                    return processed
                time.sleep(self.poll_interval)
                continue
            if use_waves:
                # STOP/max_slides are honored between waves; the wave cap
                # bounds how much work a STOP must wait for
                cap = self.wave_size if self.pipeline else 1
                if max_slides is not None:
                    cap = min(cap, max_slides - processed)
                processed += self._process_wave(pending[:cap])
                if max_slides is not None and processed >= max_slides:
                    return processed
                continue
            for path in pending:
                row = self.process_ticket(path)
                if row is None:
                    continue  # a peer server claimed it first
                self._emit(row)
                processed += 1
                if ((max_slides is not None and processed >= max_slides)
                        or os.path.exists(self.stop_file)
                        or self._needs_recycle()):
                    return processed
