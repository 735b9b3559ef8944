"""The ten corpus classes of the ratio contract, read from the machine.

The port's own copy of ``scripts/contract_margins.py``'s ``corpora(cap)``:
the same files, in the same order, cut the same way.  Every class reads
files of the machine or of the checkout only, and nothing is fetched:

- ``libc_elf``, ``bash_elf``, ``sqlite_db``: the first ``cap`` bytes of
  ``/usr/lib/x86_64-linux-gnu/libc.so.6``, ``/bin/bash`` and
  ``/usr/share/proj/proj.db``;
- ``doc_text``: the ``/usr/share/doc/*/copyright`` files, concatenated;
- ``json_cfg``: ``/usr/share/gdal/*.json``, concatenated;
- ``py_source``: the ``.py`` files of the numpy package tree;
- ``pg11``: ``tests/data/pg11.txt`` repeated to ``cap``;
- ``issue18``: ``tests/data/issue_18_201911.bin``;
- ``tar_tree``: a tar of the numpy package tree;
- ``etc_text``: the readable files under ``/etc`` (at least 32 KiB of them).

A class whose files are absent gives no bytes: ``corpora`` leaves it out and
names it among the skipped.
"""

from __future__ import annotations

import glob
import io
import os
import tarfile

import numpy as np

from ..utils.mix import pg11

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLASSES = ("libc_elf", "bash_elf", "sqlite_db", "doc_text", "json_cfg", "py_source", "pg11",
           "issue18", "tar_tree", "etc_text")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _concat(paths, cap: int, limit: int) -> bytes:
    """The files of ``paths`` (the first ``limit``) concatenated until they
    pass ``cap`` bytes; unreadable files are passed over."""
    parts = []
    for p in paths[:limit]:
        try:
            parts.append(_read(p))
        except OSError:
            continue
        if sum(map(len, parts)) > cap:
            break
    return b"".join(parts)


def corpora(cap: int) -> tuple[dict, list]:
    """({class: its first ``cap`` bytes}, [classes skipped: no files here])."""
    out = {}
    for name, path in (("libc_elf", "/usr/lib/x86_64-linux-gnu/libc.so.6"),
                       ("bash_elf", "/bin/bash"), ("sqlite_db", "/usr/share/proj/proj.db")):
        if os.path.exists(path):
            out[name] = _read(path)[:cap]
    out["doc_text"] = _concat(sorted(glob.glob("/usr/share/doc/*/copyright")), cap, 2000)[:cap]
    out["json_cfg"] = _concat(sorted(glob.glob("/usr/share/gdal/*.json")), cap, 400)[:cap]
    npdir = os.path.dirname(np.__file__)
    py = sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True))
    out["py_source"] = _concat(py, cap, len(py))[:cap]
    pg = pg11()
    out["pg11"] = (pg * (cap // len(pg) + 1))[:cap]
    out["issue18"] = _read(os.path.join(REPO, "tests", "data", "issue_18_201911.bin"))[:cap]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        total = 0
        for p in sorted(glob.glob(os.path.join(npdir, "**", "*"), recursive=True)):
            if os.path.isfile(p):
                t.add(p, arcname=os.path.relpath(p, npdir))
                total += os.path.getsize(p)
            if total > cap:
                break
    out["tar_tree"] = buf.getvalue()[:cap]
    etc = _concat(sorted(q for q in glob.glob("/etc/**/*", recursive=True)
                         if os.path.isfile(q) and os.access(q, os.R_OK)), cap, 4000)
    if len(etc) >= 32 * 1024:
        out["etc_text"] = etc[:cap]
    found = {k: v for k, v in out.items() if v}
    return found, [k for k in CLASSES if k not in found]
