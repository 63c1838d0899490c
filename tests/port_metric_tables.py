"""The README's two metric tables as the port's tests read them.

The main table (``<!-- metrics:begin -->`` ... ``<!-- metrics:end -->``)
documents the names both packages book. The second table
(``<!-- port-metrics:begin -->`` ... ``<!-- port-metrics:end -->``)
lists the spans only the port books. ``scripts/check_metrics.py`` reads
the main table alone; these helpers point its own scanners at the
second table's markers, so the lint's code stays the reference's.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BEGIN = "<!-- port-metrics:begin -->"
PORT_END = "<!-- port-metrics:end -->"


def lint_module():
    """``scripts/check_metrics.py``, imported."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import check_metrics as cm
    finally:
        sys.path.pop(0)
    return cm


def in_port_table(cm, scan):
    """``scan()`` (one of the lint's README scanners) over the second
    table."""
    begin, end = cm.MARK_BEGIN, cm.MARK_END
    cm.MARK_BEGIN, cm.MARK_END = PORT_BEGIN, PORT_END
    try:
        return scan()
    finally:
        cm.MARK_BEGIN, cm.MARK_END = begin, end


def port_table(cm=None):
    """The names of the second table's rows."""
    cm = cm or lint_module()
    return set(in_port_table(cm, cm.scan_readme_kinds))


def read_both_tables(cm, monkeypatch):
    """Make the lint's scanners read the main table and the second one
    together, as the port's names are documented."""
    names, kinds = cm.scan_readme, cm.scan_readme_kinds
    monkeypatch.setattr(
        cm, "scan_readme", lambda: names() | in_port_table(cm, names))
    monkeypatch.setattr(
        cm, "scan_readme_kinds",
        lambda: {**kinds(), **in_port_table(cm, kinds)})
