"""The live-reconfig control channel, the counterpart of
``firedancer_tpu/disco/soak.py`` (``_read_request``:437,
``ReconfigController``:461-537). The rest of the JAX soak harness (its
plan, probes and judgment) is not ported.

A ``ReconfigController`` watches a JSON request file: a change of its
mtime, or ``trigger()`` (what a SIGHUP handler calls), reads the request
and parks it on the attached verify tile (``VerifyTile.request_reconfig``),
whose dispatcher applies it at the next inflight barrier. The request's
keys are the tile's (``tiles.RECONFIG_KEYS``: ``verify_mode``,
``ladder``, ``frontend``, ``drain``); the JAX request's ``env`` flag
flips have no counterpart, since the port takes no flags. Every attempt,
accepted or refused, is one entry of ``log``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


def _read_request(path: Optional[str]) -> dict:
    """The request in path; {} when there is none, it does not parse or
    it is not a JSON object."""
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            req = json.load(f)
        return req if isinstance(req, dict) else {}
    except (OSError, ValueError):
        return {}


class ReconfigController:
    """The control channel of one verify tile: a thread polls path's
    mtime every poll_s seconds (a file present at start() does not
    fire) and the hup event (trigger()); either reads the request and
    applies it."""

    def __init__(self, path: Optional[str] = None, poll_s: float = 0.2):
        self.path = path
        self.poll_s = poll_s
        self.log: List[dict] = []
        self.tile = None
        self.hup = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, tile) -> None:
        self.tile = tile

    def trigger(self) -> None:
        """The SIGHUP entry point (a signal handler only sets the event)."""
        self.hup.set()

    def start(self) -> "ReconfigController":
        self._thread = threading.Thread(target=self._loop,
                                        name="soak-reconfig", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def apply(self, req: dict) -> dict:
        """Park req on the tile; one log entry either way (called by the
        poll loop, or directly)."""
        tile = self.tile
        if tile is None:
            ok, detail = False, "no tile attached"
        else:
            ok, detail = tile.request_reconfig(req)
        ent = {"ok": bool(ok), "detail": detail, "t": time.perf_counter(),
               "ladder": req.get("ladder"),
               "verify_mode": req.get("verify_mode"),
               "frontend": req.get("frontend"), "drain": req.get("drain")}
        self.log.append(ent)
        return ent

    def _loop(self) -> None:
        seen = -1.0
        if self.path:
            try:
                seen = os.stat(self.path).st_mtime
            except OSError:
                seen = -1.0
        while not self._stop.wait(self.poll_s):
            fire = self.hup.is_set()
            if self.path:
                try:
                    m = os.stat(self.path).st_mtime
                except OSError:
                    m = None
                if m is not None and m != seen:
                    seen = m
                    fire = True
            if not fire:
                continue
            self.hup.clear()
            req = _read_request(self.path)
            if req:
                self.apply(req)
