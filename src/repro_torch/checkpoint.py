"""Atomic directory commits, the primitive under index persistence.

The port's own copy of ``repro.checkpoint.checkpointer.atomic_replace_dir``
(the rest of that checkpointer belongs to the JAX package's model
scaffolding and is not ported).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

__all__ = ["atomic_replace_dir"]


@contextlib.contextmanager
def atomic_replace_dir(final: str):
    """Yield a temp dir that atomically replaces ``final`` when the block
    exits cleanly — a crash never loses the previous ``final``.  The commit
    is rename-only: the old dir is renamed aside (never removed before the
    new one is in place), the temp dir renamed in, then the backup removed.
    A crash between the two renames is healed on the next call (the backup
    is restored when ``final`` is missing).  The temp dir lives next to
    ``final`` so renames stay on one filesystem; it is removed on failure."""
    final = os.path.abspath(final)
    parent = os.path.dirname(final)
    backup = final + ".replaced"
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(backup):
        if os.path.exists(final):  # prior crash after commit: stale backup
            shutil.rmtree(backup)
        else:                      # prior crash mid-commit: restore
            os.rename(backup, final)
    tmp = os.path.join(
        parent, f".tmp.{os.path.basename(final)}.{os.getpid()}.{time.time_ns()}"
    )
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        os.rename(final, backup)
    os.rename(tmp, final)
    shutil.rmtree(backup, ignore_errors=True)
