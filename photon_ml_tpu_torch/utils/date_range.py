"""Date ranges as dataset coordinates + dated input-path expansion (port
of ``photon_ml_tpu/utils/date_range.py``).

Reference: photon-ml .../util/DateRange.scala (range strings
``yyyyMMdd-yyyyMMdd`` and days-ago strings ``start-end``, start must not be
after end) and util/IOUtils.scala:84-130 ``getInputPathsWithinDateRange``
(expand ``<inputDir>/daily/yyyy/MM/dd`` per day, filter missing paths,
require at least one, optionally error on any missing).

Host-side only: this feeds the input pipeline before anything touches a
device.
"""

from __future__ import annotations

import datetime as _dt
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Union

_PATTERN = "%Y%m%d"  # joda "yyyyMMdd"


@dataclass(frozen=True)
class DateRange:
    """Immutable inclusive [start, end] date range."""

    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end "
                f"date {self.end}."
            )

    def __str__(self) -> str:
        return f"{self.start.isoformat()}-{self.end.isoformat()}"

    def days(self) -> Iterator[_dt.date]:
        d = self.start
        while d <= self.end:
            yield d
            d += _dt.timedelta(days=1)

    @staticmethod
    def from_dates(range_str: str, pattern: str = _PATTERN) -> "DateRange":
        """Parse ``yyyyMMdd-yyyyMMdd`` (DateRange.fromDates)."""
        start_s, end_s = _split_range(range_str)
        try:
            start = _dt.datetime.strptime(start_s, pattern).date()
            end = _dt.datetime.strptime(end_s, pattern).date()
        except ValueError as e:
            raise ValueError(
                f"Couldn't parse the date range: {range_str}"
            ) from e
        return DateRange(start, end)

    @staticmethod
    def from_days_ago(
        range_str: str, now: Optional[_dt.date] = None
    ) -> "DateRange":
        """Parse ``startDaysAgo-endDaysAgo`` (e.g. ``90-1``),
        relative to ``now`` (DateRange.fromDaysAgo)."""
        start_s, end_s = _split_range(range_str)
        try:
            start_ago, end_ago = int(start_s), int(end_s)
        except ValueError as e:
            raise ValueError(
                f"Start days ago ({start_s}) and end days ago ({end_s}) "
                "must be valid integers."
            ) from e
        if start_ago < 0 or end_ago < 0:
            raise ValueError("Days ago cannot be negative.")
        now = now if now is not None else _dt.date.today()
        return DateRange(
            now - _dt.timedelta(days=start_ago),
            now - _dt.timedelta(days=end_ago),
        )


def _split_range(range_str: str) -> tuple:
    parts = range_str.split("-")
    if len(parts) != 2:
        raise ValueError(
            f"Couldn't parse the range: {range_str}. Be sure to separate "
            "two values with '-'."
        )
    return parts[0], parts[1]


def resolve_date_range(
    date_range: Optional[str],
    date_range_days_ago: Optional[str],
    now: Optional[_dt.date] = None,
) -> Optional[DateRange]:
    """Driver-param policy: at most one of the two forms may be given
    (cli/game/training/Params.scala exposes both; specifying both is
    ambiguous and rejected here)."""
    if date_range and date_range_days_ago:
        raise ValueError(
            "specify at most one of date-range and date-range-days-ago"
        )
    if date_range:
        return DateRange.from_dates(date_range)
    if date_range_days_ago:
        return DateRange.from_days_ago(date_range_days_ago, now=now)
    return None


def daily_path(base_dir: str, day: _dt.date) -> str:
    """``<base>/daily/yyyy/MM/dd`` (IOUtils' dailyDir layout)."""
    return os.path.join(
        base_dir, "daily", f"{day.year:04d}", f"{day.month:02d}",
        f"{day.day:02d}",
    )


def input_paths_within_date_range(
    input_dirs: Union[str, Sequence[str]],
    date_range: DateRange,
    *,
    error_on_missing: bool = False,
) -> List[str]:
    """Expand base dirs to their existing daily paths within the range.

    Mirrors IOUtils.getInputPathsWithinDateRange: one path per day under
    ``<dir>/daily/yyyy/MM/dd``; with ``error_on_missing`` every day must
    exist, otherwise missing days are skipped; zero surviving paths for a
    base dir is an error either way.
    """
    if isinstance(input_dirs, str):
        input_dirs = [input_dirs]
    out: List[str] = []
    for base in input_dirs:
        paths = [daily_path(base, day) for day in date_range.days()]
        if error_on_missing:
            for p in paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Path {p} does not exist!")
        existing = [p for p in paths if os.path.exists(p)]
        if not existing:
            raise FileNotFoundError(
                f"No data folder found between {date_range.start} and "
                f"{date_range.end} in {os.path.join(base, 'daily')}"
            )
        out.extend(existing)
    return out


def expand_dated_paths(dirs, date_range, days_ago, logger=None) -> List[str]:
    """Input dirs -> daily paths when a range is configured
    (IOUtils.getInputPathsWithinDateRange), identity otherwise; the GAME
    training and scoring drivers' input expansion."""
    rng = resolve_date_range(date_range, days_ago)
    dirs = list(dirs)
    if rng is None:
        return dirs
    paths = input_paths_within_date_range(dirs, rng)
    if logger is not None:
        logger.info(
            "date range %s expanded %d dir(s) to %d daily paths",
            rng, len(dirs), len(paths),
        )
    return paths
