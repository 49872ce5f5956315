"""Session information: lap and 3-sector bookkeeping.

The port's own copy of ``acmpc_tpu/dashboard/session.py`` (pure Python):
per-lap sector times accumulated from the live observation stream,
per-sector and per-lap bests, deltas and F1-style colour classification
(purple = session best, green = personal improvement, yellow = normal),
exposed as one JSON snapshot.

The running sector's time is the current laptime minus the sum of the
other sectors; a lap (and with it all three sectors) is finalised when
the lap counter increments.
"""

from __future__ import annotations

from typing import Dict, List, Optional

COLOUR_BEST = "purple"  # overall session best
COLOUR_IMPROVED = "green"  # personal improvement
COLOUR_NORMAL = "yellow"

N_SECTORS = 3


def format_time(milliseconds: float) -> str:
    """mm:ss.mmm."""
    if milliseconds is None or milliseconds <= 0:
        return "--:--.---"
    ms = int(milliseconds)
    minutes, ms = divmod(ms, 60000)
    seconds, ms = divmod(ms, 1000)
    return f"{minutes:02d}:{seconds:02d}.{ms:03d}"


def format_delta(delta_ms: Optional[float]) -> str:
    if delta_ms is None:
        return ""
    sign = "+" if delta_ms >= 0 else "-"
    return f"{sign}{format_time(abs(delta_ms))}"


class SessionTracker:
    def __init__(self):
        self.laps: List[Dict] = []
        self.best_time_ms: Optional[float] = None
        self.best_sector_ms: List[Optional[float]] = [None] * N_SECTORS
        self.current_lap_ms = 0.0
        self.current_sectors = [0.0] * N_SECTORS
        self.current_sector = 0
        self.last_lap: Optional[Dict] = None
        self._last_lap_count = 0

    # -- update from the live observation stream --------------------------
    def update(self, state: Dict):
        laptime = state.get("i_current_time", 0)
        sector = int(state.get("current_sector_index", 0)) % N_SECTORS
        laps = state.get("completed_laps", 0)

        if laps > self._last_lap_count:
            self._finalise_lap(state)
            self._last_lap_count = laps
            self.current_sectors = [0.0] * N_SECTORS

        self.current_lap_ms = laptime
        self.current_sector = sector
        # accumulate the running sector
        done = sum(
            t for i, t in enumerate(self.current_sectors) if i != sector
        )
        self.current_sectors[sector] = max(0.0, laptime - done)

    def _finalise_lap(self, state: Dict):
        last_ms = state.get("i_last_time", self.current_lap_ms)
        sectors = list(self.current_sectors)
        # scale closing-sector residue so sectors sum to the official lap
        # (the stream's i_last_time is authoritative)
        drift = last_ms - sum(sectors)
        sectors[-1] = max(0.0, sectors[-1] + drift)

        lap_improved = self.best_time_ms is None or last_ms < self.best_time_ms
        lap_delta = None if lap_improved else last_ms - self.best_time_ms
        if lap_improved:
            self.best_time_ms = last_ms

        sector_entries = []
        for i, t in enumerate(sectors):
            best = self.best_sector_ms[i]
            improved = best is None or t < best
            if improved:
                self.best_sector_ms[i] = t
            sector_entries.append(
                {
                    "time_ms": t,
                    "time": format_time(t),
                    "colour": COLOUR_BEST if improved else COLOUR_NORMAL,
                    "delta": format_delta(None if improved else t - best),
                }
            )

        self.last_lap = {
            "lap": self._last_lap_count + 1,
            "time_ms": last_ms,
            "time": format_time(last_ms),
            "colour": COLOUR_BEST if lap_improved else COLOUR_NORMAL,
            "delta": format_delta(lap_delta),
            "sectors": sector_entries,
        }
        self.laps.append(self.last_lap)

    # -- snapshot ----------------------------------------------------------
    def _current_entry(self) -> Dict:
        sectors = []
        for i, t in enumerate(self.current_sectors):
            running = i == self.current_sector
            best = self.best_sector_ms[i]
            show = t if (running or t > 0) else None
            improved = show is not None and (best is None or show < best)
            sectors.append(
                {
                    "time": format_time(show or 0),
                    "colour": (
                        COLOUR_IMPROVED
                        if improved and not running
                        else COLOUR_NORMAL
                    ),
                    "delta": format_delta(
                        show - best
                        if (show is not None and best is not None and not running)
                        else None
                    ),
                }
            )
        delta = (
            self.current_lap_ms - self.best_time_ms
            if self.best_time_ms is not None
            else None
        )
        return {
            "time": format_time(self.current_lap_ms),
            "colour": COLOUR_NORMAL,
            "delta": format_delta(delta),
            "sectors": sectors,
        }

    def snapshot(self) -> Dict:
        return {
            "completed_laps": self._last_lap_count,
            "current": self._current_entry(),
            "last": self.last_lap,
            "best_lap": format_time(self.best_time_ms or 0),
            "best_sectors": [
                format_time(t or 0) for t in self.best_sector_ms
            ],
            "laps": self.laps[-10:],
            # legacy keys (pre-sector snapshot layout)
            "current_lap": format_time(self.current_lap_ms),
            "current_sector": self.current_sector,
        }
