"""Versioned model-dir repository — the rollout side of persistence (port
of ``paddle_tpu/checkpoint/modeldir.py``).

Training persistence (the checkpoint manager) versions *steps* of one
run; serving
persistence versions *models*: a rollout needs an immutable, numbered
directory per published model and one atomic pointer to the newest, so
a FleetController can say "deploy latest" and an operator can roll
back by pointing at an older version. Layout::

    repo/
      v_1/                  <- one published model (immutable)
        __model__ ...        <- the save_inference_model artifacts
        warmup.npz           <- optional warmup example (replica warms
                                its bucket ladder from it)
        model_version.json   <- manifest: {version, ts, src}
      v_2/
      LATEST                 <- atomic pointer: {"version": 2, "dir": "v_2"}

The same two-phase discipline as the checkpoint manager: a publish
stages the copy under ``tmp.v_<n>.<pid>/``, writes the manifest, then
``os.replace``s into place and finally flips ``LATEST`` — a reader
(the fleet controller resolving a deploy) can never observe a torn or
half-copied version.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time

__all__ = [
    "LATEST",
    "MANIFEST",
    "publish",
    "versions",
    "latest",
    "read_manifest",
    "commit_json",
]

LATEST = "LATEST"
MANIFEST = "model_version.json"
_VERSION_DIR = re.compile(r"^v_(\d+)$")


def commit_json(path, obj, indent=None):
    """Two-phase atomic JSON commit: stage to ``<path>.tmp.<pid>``,
    then ``os.replace`` — a concurrent reader sees the old document or
    the new one, never a torn line. This is the ONE write discipline
    for every fleet shared file (``LATEST``, endpoint files,
    ``kv_peers.json``, ``fleet_state.json``, the fleet report), so
    reader-side torn-file handling has exactly one failure mode to
    cover: a file that predates its writer's crash. Returns ``path``."""
    path = str(path)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=True, indent=indent)
    os.replace(tmp, path)
    return path


def versions(repo):
    """Sorted ``[(version, abs_dir), ...]`` of fully published versions
    (a version dir without a manifest is a torn publish — invisible,
    exactly like a checkpoint dir without its manifest)."""
    out = []
    try:
        names = os.listdir(str(repo))
    except OSError:
        return out
    for name in names:
        m = _VERSION_DIR.match(name)
        if not m:
            continue
        path = os.path.join(str(repo), name)
        if os.path.isfile(os.path.join(path, MANIFEST)):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def read_manifest(model_dir):
    """The publish manifest of one version dir, or None for a plain
    (unpublished) export dir."""
    try:
        with open(os.path.join(str(model_dir), MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def latest(repo):
    """(version, abs_dir) the ``LATEST`` pointer names — falling back
    to the highest published version when the pointer is missing or
    torn — or (None, None) for an empty repo."""
    repo = str(repo)
    try:
        with open(os.path.join(repo, LATEST)) as f:
            rec = json.load(f)
        path = os.path.join(repo, rec["dir"])
        if os.path.isfile(os.path.join(path, MANIFEST)):
            return int(rec["version"]), path
    except (OSError, ValueError, KeyError, TypeError):
        pass
    pub = versions(repo)
    return pub[-1] if pub else (None, None)


def publish(export_dir, repo, version=None):
    """Copy ``export_dir`` (a ``save_inference_model`` directory) into
    the repo as the next version (or an explicit higher ``version``)
    and flip ``LATEST``. Returns (version, published_dir)."""
    export_dir, repo = str(export_dir), str(repo)
    if not os.path.isdir(export_dir):
        raise ValueError("export dir %r does not exist" % export_dir)
    os.makedirs(repo, exist_ok=True)
    pub = versions(repo)
    next_v = (pub[-1][0] + 1) if pub else 1
    if version is not None:
        if int(version) < next_v:
            raise ValueError(
                "version %d already published (next free is %d)"
                % (int(version), next_v)
            )
        next_v = int(version)
    final = os.path.join(repo, "v_%d" % next_v)
    stage = os.path.join(repo, "tmp.v_%d.%d" % (next_v, os.getpid()))
    shutil.rmtree(stage, ignore_errors=True)
    try:
        shutil.copytree(export_dir, stage)
        with open(os.path.join(stage, MANIFEST), "w") as f:
            json.dump({
                "version": next_v,
                "ts": time.time(),
                "src": os.path.abspath(export_dir),
            }, f, sort_keys=True)
        os.replace(stage, final)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    # LATEST flips last, atomically: a concurrent reader sees either
    # the old pointer or the new one, never a torn line
    commit_json(os.path.join(repo, LATEST),
                {"version": next_v, "dir": "v_%d" % next_v})
    return next_v, final
