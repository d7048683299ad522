"""Minimal XLSX (SpreadsheetML) sheet reader, host-side: a copy of
``sustaingym_tpu.utils.xlsx`` (stdlib ``zipfile`` and ``ElementTree``).

openpyxl is not a dependency; the cogen ETL only needs to read simple
value grids from the ERCOT day-ahead price workbooks
(``cogen/ambients_data/rpt.*.xlsx`` of the reference distribution's data,
read by its ``sustaingym/data/cogen/load_ambients.py:52-55``), so this
implements just: shared strings, inline numbers, per-sheet cell grids.
"""
from __future__ import annotations

import re
import zipfile
from xml.etree import ElementTree

__all__ = ["read_workbook", "sheet_names"]

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _col_index(letters: str) -> int:
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def _shared_strings(zf: zipfile.ZipFile) -> list[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ElementTree.fromstring(data)
    strings = []
    for si in root.iter(f"{_NS}si"):
        strings.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
    return strings


def sheet_names(path: str) -> list[str]:
    with zipfile.ZipFile(path) as zf:
        root = ElementTree.fromstring(zf.read("xl/workbook.xml"))
        return [s.attrib["name"] for s in root.iter(f"{_NS}sheet")]


def read_workbook(path: str) -> dict[str, list[list]]:
    """Reads every sheet into a dense row-major grid of python values
    (float for numeric cells, str for shared/inline strings, None for
    empty)."""
    out: dict[str, list[list]] = {}
    with zipfile.ZipFile(path) as zf:
        strings = _shared_strings(zf)
        root = ElementTree.fromstring(zf.read("xl/workbook.xml"))
        names = [s.attrib["name"] for s in root.iter(f"{_NS}sheet")]
        # sheets are stored as xl/worksheets/Sheet{i}.xml in workbook order
        sheet_files = sorted(
            (n for n in zf.namelist()
             if n.startswith("xl/worksheets/") and n.endswith(".xml")),
            key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)))
        for name, fname in zip(names, sheet_files):
            rows: list[list] = []
            sheet_root = ElementTree.fromstring(zf.read(fname))
            for row_el in sheet_root.iter(f"{_NS}row"):
                row: list = []
                for cell in row_el.iter(f"{_NS}c"):
                    ref = cell.attrib.get("r", "")
                    m = _CELL_REF.match(ref)
                    col = _col_index(m.group(1)) if m else len(row)
                    while len(row) <= col:
                        row.append(None)
                    ctype = cell.attrib.get("t", "n")
                    v_el = cell.find(f"{_NS}v")
                    if v_el is None or v_el.text is None:
                        is_el = cell.find(f"{_NS}is")
                        if is_el is not None:
                            row[col] = "".join(
                                t.text or "" for t in is_el.iter(f"{_NS}t"))
                        continue
                    if ctype == "s":
                        row[col] = strings[int(v_el.text)]
                    elif ctype == "str":
                        row[col] = v_el.text
                    else:
                        row[col] = float(v_el.text)
                rows.append(row)
            out[name] = rows
    return out
