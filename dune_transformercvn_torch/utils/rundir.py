"""Versioned run directories: ``{log_dir}/{name}/version_{i}``.

The port's own copy of ``dune_transformercvn_tpu/utils/rundir.py`` (kept
equal to it by ``tests/test_torch_port_loop.py``).  It mirrors the
TensorBoardLogger convention the reference relies on (train.py:103-105,
README.md:60): repeated trainings under the same name increment the version
number, and the resolved ``options.json`` is dumped beside the logs so
evaluation can rebuild the exact model.
"""

from __future__ import annotations

import os
import re
from typing import List


def find_versions(log_dir: str, name: str) -> List[int]:
    base = os.path.join(log_dir, name)
    if not os.path.isdir(base):
        return []
    versions = []
    for entry in os.listdir(base):
        m = re.fullmatch(r"version_(\d+)", entry)
        if m and os.path.isdir(os.path.join(base, entry)):
            versions.append(int(m.group(1)))
    return sorted(versions)


def find_resumable(log_dir: str, name: str):
    """Newest version dir that already has saved checkpoints, or None.

    The ``--auto_resume`` preemption-recovery scan: versions that died
    before their first checkpoint save (no ``checkpoints/index.json``) are
    skipped so the resume lands on real state.
    """
    for version in reversed(find_versions(log_dir, name)):
        candidate = os.path.join(log_dir, name, f"version_{version}")
        if os.path.exists(
            os.path.join(candidate, "checkpoints", "index.json")
        ):
            return candidate
    return None


def create_run_dir(log_dir: str, name: str) -> str:
    versions = find_versions(log_dir, name)
    version = (versions[-1] + 1) if versions else 0
    while True:
        path = os.path.join(log_dir, name, f"version_{version}")
        try:
            # exist_ok=False makes creation atomic: two concurrent launches
            # (e.g. an HPO sweep) cannot claim the same version directory
            os.makedirs(path, exist_ok=False)
            return path
        except FileExistsError:
            version += 1
