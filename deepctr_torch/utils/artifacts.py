"""Artifact freshness: tie generated evidence files to their generating tool.

A copy of ``deepctr_tpu/utils/artifacts.py`` (``tool_hash``,
``protocol_stamp``, ``read_stamp``, ``parse_md_table``, ``float_or_none``
and ``REPO_ROOT``, the repository's root), so that the port's tools stamp
their artifacts without importing the JAX package;
``tests/test_torch_artifacts.py`` holds the copy equal to its original.

Every generating tool embeds ``protocol: <tool>@<hash>`` in its artifact's
footer, where ``<hash>`` is a digest of the tool's source at generation
time; the tests recompute the digest of the tool at HEAD and fail if a
shipped artifact was generated by a different protocol, and re-parse each
artifact's own tables against the band the artifact itself declares (a
per-row ``band`` column). The digest covers the whole tool file: any edit
to a generating tool invalidates its artifact until the tool is re-run.
"""

from __future__ import annotations

import hashlib
import os
import re

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_STAMP_RE = re.compile(r"protocol:\s*(\S+)@([0-9a-f]{16})")


def tool_hash(tool_relpath: str) -> str:
    """Digest (16 hex chars) of a generating tool's source at HEAD."""
    with open(os.path.join(REPO_ROOT, tool_relpath), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def protocol_stamp(tool_relpath: str) -> str:
    """Footer line a generating tool writes into its artifact."""
    return f"protocol: {tool_relpath}@{tool_hash(tool_relpath)}"


def read_stamp(artifact_path: str) -> tuple[str, str] | None:
    """(tool_relpath, hash) recorded in an artifact, or None if unstamped."""
    with open(artifact_path) as f:
        m = _STAMP_RE.search(f.read())
    return (m.group(1), m.group(2)) if m else None


def parse_md_table(text: str) -> list[dict]:
    """Parse the FIRST pipe table in ``text`` into a list of row dicts.

    Cell values are kept as strings; numeric-looking cells also get a
    float under the same key via ``float_or_none``.
    """
    lines = [ln for ln in text.splitlines() if ln.strip().startswith("|")]
    if len(lines) < 3:
        return []
    header = [c.strip() for c in lines[0].strip("|").split("|")]
    rows = []
    for ln in lines[2:]:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        if len(cells) != len(header):
            break
        rows.append(dict(zip(header, cells)))
    return rows


def float_or_none(cell: str):
    """First float in a table cell ('0.7358 ± 0.0001' -> 0.7358)."""
    m = re.search(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", cell.replace("±", " "))
    return float(m.group(0)) if m else None
