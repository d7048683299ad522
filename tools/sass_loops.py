#!/usr/bin/env python3
"""Loops of a compiled kernel and the instructions in each, from its SASS.

    cuobjdump -sass LIBRARY.so > kernels.sass
    python3 tools/sass_loops.py kernels.sass NAME_PART

For every function of the listing whose mangled name holds ``NAME_PART``,
prints its instruction count and, for each backward branch (a loop), the
loop's first and last instruction, its length and its most frequent
opcodes. The hot loop of an issue-bound kernel shows where its issue
slots go (a FISTA iteration of ``ev_segment_kernel``, a k16 step of the
building actor). ``cuobjdump`` ships with the CUDA toolkit
(``/usr/local/cuda/bin``); run it where the kernels were built.
"""
from __future__ import annotations

import collections
import re
import sys


def functions(path: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled name: [(address, instruction text), ...]}."""
    out: dict[str, list[tuple[int, str]]] = {}
    name = None
    with open(path) as f:
        for line in f:
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                out[name] = []
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m and name:
                out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(ins: str) -> str:
    """The opcode without its predicate and modifiers."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]


def loops(code: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last) instruction index of each backward branch's loop."""
    index = {a: i for i, (a, _) in enumerate(code)}
    found = []
    for i, (a, ins) in enumerate(code):
        m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in index:
            found.append((index[int(m.group(1), 16)], i))
    return found


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    path, part = sys.argv[1:]
    for name, code in functions(path).items():
        if part not in name:
            continue
        print(f"{name}: {len(code)} instructions")
        for lo, hi in loops(code):
            ops = collections.Counter(opcode(s) for _, s in code[lo:hi + 1])
            print(f"  loop {lo}-{hi}: {hi - lo + 1} instructions; "
                  f"{', '.join(f'{k} {v}' for k, v in ops.most_common(12))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
