#!/usr/bin/env python3
"""Count the instructions on the squeeze kernel's loop-carried chain in its
SASS.

    python3 tools/squeeze_sass.py [LIBRARY [KERNEL]] [--dump FILE]

Runs `cuobjdump -sass` on a built kernel library (by default the port's
jxl_oxide_tpu_torch/_build/libmodular_squeeze.so, built first if missing)
and takes the function whose name contains KERNEL (default
inv_squeeze_h_kernel; of a template's instances, the one with the longest
chain). In the basic block with the longest register dependency path (the
unrolled walk of a tile: the chain of every step runs through it, left ->
... -> second -> the next step's left), it finds that path, the period
with which its opcodes repeat (one step), and counts the opcodes of one
period in the middle of the path (`chain`: a period may be two steps).
Prints one JSON line: {"kernel", "function", "block_instructions",
"path_instructions", "steps_on_path", "steps_per_period", "ops_per_step",
"by_opcode" (of one period)}. --dump writes the function's SASS to FILE.

The count explains the chain probe's time (csrc/squeeze_probe.cu,
chip_smoke.py); it is not a bound: it counts instructions, not their
latencies. cuobjdump is the CUDA toolkit's (/usr/local/cuda/bin), or the
copy Triton's package carries under triton/backends/nvidia/bin/.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_KERNEL = "inv_squeeze_h_kernel"

# opcodes that write no register: every register operand is read
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "BRX", "EXIT",
            "RET", "CALL", "JMP", "NOP", "WARPSYNC", "BSSY", "BSYNC", "DEPBAR",
            "MEMBAR", "CCTL", "ERRBAR", "FENCE", "UTMALDG", "UTMASTG",
            "UBLKCP", "ARRIVES", "YIELD", "BPT", "KILL", "NANOSLEEP")
# opcodes that write two predicates first (ISETP P0, PT, ...)
_TWO_PRED_DEST = ("ISETP", "FSETP", "DSETP", "HSETP2", "PSETP", "PLOP3",
                  "UISETP", "UPLOP3", "UPSETP")
# control flow: a basic block ends after it
_BRANCH = ("BRA", "BRX", "EXIT", "RET", "CALL", "JMP", "BSYNC", "BSSY",
           "WARPSYNC", "BAR", "KILL")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d+)(\.64|\.128)?(?![\w])")


class Instr:
    """One SASS instruction: its address, opcode (with modifiers), the
    registers it writes and reads, and a branch target if it has one."""

    def __init__(self, addr: int, text: str):
        self.addr = addr
        self.text = text
        pred = None
        m = re.match(r"@(!?)(U?P\d+|U?PT)\s+(.*)", text)
        if m:
            pred, text = m.group(2), m.group(3)
        parts = text.split(None, 1)
        self.opcode = parts[0]
        self.base = self.opcode.split(".")[0]
        operands = ([o.strip() for o in parts[1].split(",")]
                    if len(parts) > 1 else [])
        self.target = None
        m = re.search(r"0x[0-9a-f]+", parts[1]) \
            if len(parts) > 1 and self.base in ("BRA", "BSSY", "CALL") \
            else None
        if m:
            self.target = int(m.group(0), 16)
        width = 4 if ".128" in self.opcode else (
            2 if (".64" in self.opcode or ".WIDE" in self.opcode) else 1)
        dst_ops, src_ops = self._split(operands)
        self.dests = set()
        for op in dst_ops:
            self.dests |= _regs(op, width)
        self.srcs = set()
        for op in src_ops:
            data = self.base in ("ST", "STS", "STG", "STL") and "[" not in op
            self.srcs |= _regs(op, width if data else 1)
        if pred is not None and pred not in ("PT", "UPT"):
            self.srcs.add(pred)
            # a predicated write keeps the old value where it is off
            self.srcs |= self.dests

    def _split(self, operands):
        if not operands or self.base in _NO_DEST:
            return [], operands
        if self.base in _TWO_PRED_DEST:
            return operands[:2], operands[2:]
        n = 1
        while n < len(operands) and re.fullmatch(r"!?U?P(\d+|T)",
                                                 operands[n]):
            n += 1
        if self.base in ("SEL", "FSEL", "USEL"):
            n = 1
        return operands[:n], operands[n:]


def _regs(op: str, width: int) -> set:
    """Registers named in one operand: R/UR/P/UP numbers; a register with
    .64 or .128 (or the opcode's width) names its pair or quad too."""
    out = set()
    for name, suffix in _REG.findall(op):
        out.add(name)
        n = {".64": 2, ".128": 4}.get(suffix, width)
        if name.lstrip("U").startswith("R") and n > 1:
            prefix = "UR" if name.startswith("U") else "R"
            base = int(name[len(prefix):])
            out |= {f"{prefix}{base + i}" for i in range(1, n)}
    return out


def functions(sass: str) -> dict:
    """{function name: [Instr]} of cuobjdump -sass output."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSTR.search(line)
        if m and name is not None:
            funcs[name].append(Instr(int(m.group(1), 16), m.group(2)))
    return funcs


def basic_blocks(instrs: list) -> list:
    """The instructions cut into basic blocks: after each control-flow
    instruction and before each branch target."""
    targets = {ins.target for ins in instrs if ins.target is not None}
    blocks, cur = [], []
    for ins in instrs:
        if ins.addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(ins)
        if ins.base in _BRANCH:
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def longest_path(block: list) -> list:
    """The longest chain of register dependencies (read after write) in a
    block, as its instructions in order; ties go to the earliest."""
    last_def: dict[str, int] = {}
    depth = [0] * len(block)
    prev = [-1] * len(block)
    for i, ins in enumerate(block):
        for reg in sorted(ins.srcs):
            j = last_def.get(reg)
            if j is not None and depth[j] > depth[i] - 1:
                depth[i] = depth[j] + 1
                prev[i] = j
        for reg in ins.dests:
            last_def[reg] = i
    if not block:
        return []
    end = max(range(len(block)), key=lambda i: (depth[i], -i))
    path = []
    while end >= 0:
        path.append(block[end])
        end = prev[end]
    return path[::-1]


def period(opcodes: list, match: float = 0.8) -> int | None:
    """The shortest p with which the middle half of `opcodes` repeats
    (seq[i] == seq[i + p] for at least `match` of its positions)."""
    n = len(opcodes)
    lo, hi = n // 4, 3 * n // 4
    for p in range(3, max(3, (hi - lo) // 2) + 1):
        idx = range(lo, hi - p)
        if len(idx) < p:
            break
        same = sum(opcodes[i] == opcodes[i + p] for i in idx)
        if same >= match * len(idx):
            return p
    return None


def chain(instrs: list) -> dict:
    """The loop-carried chain of the function's longest-path block: its
    length, the period of its opcodes and the opcodes of one period taken
    from the middle of the path. A period may span several steps where
    the compiler lays out steps in pairs: each step's chain holds one
    IMAD.HI (the quotient by 12 of the tendency's candidate on the path),
    so their count in the period is its steps, and ops_per_step the
    period's length over them."""
    block = max(basic_blocks(instrs), key=lambda b: len(longest_path(b)))
    path = longest_path(block)
    ops = [ins.opcode for ins in path]
    p = period(ops)
    out = {"block_instructions": len(block), "path_instructions": len(path),
           "steps_on_path": None, "steps_per_period": None,
           "ops_per_step": None, "by_opcode": None}
    if p is not None:
        mid = len(ops) // 2
        window = ops[mid:mid + p]
        k = max(1, sum(op.startswith("IMAD.HI") for op in window))
        per_step = p / k if p % k else p // k
        out.update(steps_on_path=round(len(path) / per_step, 1),
                   steps_per_period=k, ops_per_step=per_step,
                   by_opcode=dict(collections.Counter(window).most_common()))
    return out


def cuobjdump() -> str:
    """The cuobjdump of the CUDA toolkit, else of Triton's package."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        return "/usr/local/cuda/bin/cuobjdump"
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        for root in spec.submodule_search_locations:
            path = os.path.join(root, "backends", "nvidia", "bin",
                                "cuobjdump")
            if os.path.exists(path):
                return path
    raise RuntimeError("cuobjdump not found (CUDA toolkit or Triton)")


def analyse(library: str, kernel: str = DEFAULT_KERNEL,
            dump: str | None = None) -> dict:
    """cuobjdump -sass of `library`; the chain of the function whose name
    contains `kernel` (the first such)."""
    sass = subprocess.run([cuobjdump(), "-sass", library], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    funcs = functions(sass)
    names = [n for n in funcs if kernel in n]
    if not names:
        raise RuntimeError(f"no function {kernel} in {library}: "
                           f"{sorted(funcs)}")
    # of several (a template's instances), the one with the longest chain
    found = {n: chain(funcs[n]) for n in names}
    name = max(names, key=lambda n: found[n]["path_instructions"])
    if dump:
        with open(dump, "w") as f:
            f.write("\n".join(f"/*{i.addr:04x}*/ {i.text}"
                              for i in funcs[name]))
    return {"kernel": kernel, "function": name, **found[name]}


def main() -> int:
    args = sys.argv[1:]
    dump = None
    if "--dump" in args:
        i = args.index("--dump")
        dump = args[i + 1]
        del args[i:i + 2]
    if args:
        library = args[0]
    else:
        sys.path.insert(0, REPO)
        from jxl_oxide_tpu_torch.ops.cuda import build

        library = build.build("modular_squeeze")
    kernel = args[1] if len(args) > 1 else DEFAULT_KERNEL
    print(json.dumps(analyse(library, kernel, dump)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
