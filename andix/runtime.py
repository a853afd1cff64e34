"""Run configuration and soft-error state.

Replacement for the reference's global flag word and model enum
(``src/global.h:20-99``, globals in ``src/andi.c:45-50``).  Instead of a
process-wide bitmask mutated from OpenMP threads, configuration is an explicit
immutable-ish context object threaded through the pipeline; only the warning
flags mutate.
"""

from __future__ import annotations

import dataclasses
import enum
import sys


class Model(enum.Enum):
    """Evolutionary models (reference ``src/global.h`` M_* enum)."""

    RAW = "Raw"
    JC = "JC"
    KIMURA = "Kimura"
    LOGDET = "LogDet"
    ANI = "ANI"


class Progress(enum.Enum):
    AUTO = "auto"
    ALWAYS = "always"
    NEVER = "never"


@dataclasses.dataclass
class Context:
    """All run-wide knobs plus mutable warning state."""

    model: Model = Model.JC
    anchor_p_value: float = 0.025  # src/andi.c:48
    bootstrap: int = 0  # number of *extra* matrices, src/andi.c:198
    join: bool = False
    low_memory: bool = False
    truncate_names: bool = False
    verbose: int = 0  # 0, 1 (-v), 2 (-vv extra verbose)
    progress: Progress = Progress.AUTO
    threads: int = 0  # 0 = all processors (host replay workers)
    seed: int | None = None  # reproducible bootstrap (reference TODO)
    prog: str = "andix"
    backend: str = "auto"  # 'auto' | 'jax' | 'numpy'
    block_syms: int = 1 << 27  # max joint-text symbols per subject block
    checkpoint_dir: str | None = None  # tile-level resume directory

    # mutable state, reference F_NON_ACGT / F_SOFT_ERROR / F_SHORT
    non_acgt: bool = False
    soft_error: bool = False
    short_warned: bool = False

    def soft_err(self, msg: str) -> None:
        """Warn and mark the run failed (reference ``soft_errx``,
        ``src/global.h:85-99``)."""
        print(f"{self.prog}: {msg}", file=sys.stderr)
        self.soft_error = True

    def warn(self, msg: str) -> None:
        print(f"{self.prog}: {msg}", file=sys.stderr)

    @property
    def exit_code(self) -> int:
        return 1 if self.soft_error else 0
