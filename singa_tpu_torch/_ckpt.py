"""Checkpoint-directory helpers (the port's copy of the part of
singa_tpu/resilience.py that `Model.save_checkpoint` uses): a
checkpoint `.../step_N` is complete when the manifest
`.../step_N.manifest.json` sits beside it; the resilience layer writes
that manifest once the checkpoint's bytes are durable.
"""

from __future__ import annotations

import json
import os
import shutil

MANIFEST_SUFFIX = ".manifest.json"


def manifest_path(step_dir: str) -> str:
    """`.../step_N` -> `.../step_N.manifest.json` (a sibling, so it
    survives a rewrite of the directory)."""
    return os.path.abspath(step_dir).rstrip(os.sep) + MANIFEST_SUFFIX


def read_manifest(step_dir: str) -> "dict | None":
    """The manifest of `step_dir`, or None when it is missing or
    unreadable (the checkpoint is then not known to be complete)."""
    try:
        with open(manifest_path(step_dir), encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) \
            or man.get("kind") != "singa_ckpt_manifest" \
            or not isinstance(man.get("step"), int):
        return None
    return man


def is_complete_checkpoint(step_dir: str) -> bool:
    """True when `step_dir` exists and carries a readable manifest."""
    return os.path.isdir(step_dir) and read_manifest(step_dir) is not None


def set_aside_checkpoint(path: str, suffix: str, keep: int = 3) -> str:
    """Rename the checkpoint directory `path` to `path + suffix` (numbered
    on a collision), its manifest first, so a crash between the two
    renames leaves an unmanifested directory, never a manifested half.
    At most `keep` set-asides of (path, suffix) are kept, the oldest
    deleted first. Returns the destination."""
    dst = path + suffix
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = f"{path}{suffix}{i}"
    try:
        os.replace(manifest_path(path), dst + MANIFEST_SUFFIX)
    except OSError:
        pass   # no manifest to move
    os.replace(path, dst)
    base = os.path.basename(path) + suffix
    parent = os.path.dirname(path)
    aside = [os.path.join(parent, n) for n in os.listdir(parent)
             if n.startswith(base) and not n.endswith(MANIFEST_SUFFIX)
             and os.path.isdir(os.path.join(parent, n))]
    aside.sort(key=os.path.getmtime)
    for p in aside[:-keep] if len(aside) > keep else []:
        try:
            os.remove(p + MANIFEST_SUFFIX)
        except OSError:
            pass
        shutil.rmtree(p, ignore_errors=True)
    return dst


__all__ = ["MANIFEST_SUFFIX", "is_complete_checkpoint", "manifest_path",
           "read_manifest", "set_aside_checkpoint"]
