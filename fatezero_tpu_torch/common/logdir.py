"""The result folder of a CLI run, shared by the edit and tuning CLIs."""
from __future__ import annotations

import os
import time
from typing import Optional


def logdir_for(config_path: str, logdir: Optional[str]) -> str:
    """`logdir`, or a new folder result/<config stem>/<timestamp>. The stamp
    has one-second resolution, so a run that starts in the same second as
    another of the same config gets the first free `_<n>` suffix; the folder
    is created here, so two processes never claim the same one."""
    if logdir:
        return logdir
    stem = os.path.splitext(os.path.basename(config_path))[0]
    base = os.path.join("result", stem, time.strftime("%Y-%m-%dT%H-%M-%S"))
    os.makedirs(os.path.dirname(base), exist_ok=True)
    path, n = base, 0
    while True:
        try:
            os.mkdir(path)
            return path
        except FileExistsError:
            n += 1
            path = f"{base}_{n}"
