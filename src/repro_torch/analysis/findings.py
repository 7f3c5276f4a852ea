"""Finding and baseline plumbing shared by both PlaneCheck pass families
(a copy of ``repro.analysis.findings`` with the port's rule catalog).

A finding is anchored by ``(rule, file, symbol)``: the file is
repo-relative, the symbol is the enclosing function/method qualname (or
the lock cycle for ``PC-L001``).  The committed baseline matches on
that triple -- not on line numbers -- so unrelated edits to a file do
not invalidate accepted entries, while moving an accepted pattern into
a new function re-surfaces it for review.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

#: Rule catalog: id -> one-line description (mirrored in the README).
RULES: Dict[str, str] = {
    "PC-H001": "host sync inside a hot loop (.item/.tolist/.numpy on a "
               "tensor, .cpu(), torch.cuda.synchronize, Event/Stream"
               ".synchronize)",
    "PC-H002": "host cast of a tensor inside a hot loop (float/int/bool "
               "wait for the device)",
    "PC-H003": "Python control flow (if/while/assert/ternary) on a "
               "tensor's value inside a hot loop",
    "PC-H004": "per-call host-to-device construction inside a hot loop "
               "(torch.tensor/as_tensor(..., device=), "
               "torch.from_numpy(...).to(device))",
    "PC-L001": "lock-order inversion (cycle in the lock-acquisition "
               "graph)",
    "PC-L002": "guarded field mutated without its # guarded-by: lock",
    "PC-L003": "blocking work (compile, device sync, file I/O, join) "
               "while holding a lock",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete site."""

    rule: str
    file: str                  # repo-relative, forward slashes
    line: int
    symbol: str                # enclosing function/method qualname
    message: str
    hint: str = ""

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.symbol)

    def format(self) -> str:
        text = f"{self.file}:{self.line}: {self.rule} [{self.symbol}] " \
               f"{self.message}"
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Baseline:
    """Checked-in accepted findings, each with a justification.

    File format (``PLANECHECK_TORCH_BASELINE.json``)::

        {"entries": [{"rule": "PC-...", "file": "src/...",
                      "symbol": "qualname",
                      "justification": "one line why this is deliberate"}]}

    An entry without a non-empty justification is itself an error --
    the baseline documents accepted debt, it is not a mute button.
    """

    def __init__(self, entries: Iterable[dict] = ()):
        self.entries: List[dict] = list(entries)
        self._keys = {(e.get("rule", ""), e.get("file", ""),
                       e.get("symbol", "")) for e in self.entries}
        self._hits: set = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path) as fh:
            doc = json.load(fh)
        return cls(doc.get("entries", []))

    def validate(self) -> List[str]:
        """Malformed-entry errors (missing keys, empty justification)."""
        errors = []
        for e in self.entries:
            missing = [k for k in ("rule", "file", "symbol")
                       if not e.get(k)]
            if missing:
                errors.append(f"baseline entry {e!r} missing {missing}")
            if not str(e.get("justification", "")).strip():
                errors.append(
                    f"baseline entry for {e.get('rule')} at "
                    f"{e.get('file')}:{e.get('symbol')} has no "
                    "justification")
        return errors

    def covers(self, finding: Finding) -> bool:
        if finding.key in self._keys:
            self._hits.add(finding.key)
            return True
        return False

    def stale(self) -> List[dict]:
        """Entries that matched nothing in the last run (drift signal)."""
        return [e for e in self.entries
                if (e.get("rule", ""), e.get("file", ""),
                    e.get("symbol", "")) not in self._hits]

    @staticmethod
    def write(path: str, findings: Iterable[Finding],
              justification: str = "TODO: justify or fix") -> None:
        entries = []
        seen = set()
        for f in findings:
            if f.key in seen:
                continue
            seen.add(f.key)
            entries.append({"rule": f.rule, "file": f.file,
                            "symbol": f.symbol,
                            "justification": justification})
        with open(path, "w") as fh:
            json.dump({"entries": entries}, fh, indent=2)
            fh.write("\n")


def relpath(path: str, root: Optional[str] = None) -> str:
    root = root or os.getcwd()
    try:
        rel = os.path.relpath(os.path.abspath(path), root)
    except ValueError:
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")
