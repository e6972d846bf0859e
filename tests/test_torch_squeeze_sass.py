"""tools/squeeze_sass.py, which counts the squeeze kernel's loop-carried
chain in its SASS, on cuobjdump-style text written here (the CUDA
toolkit and the card are elsewhere: chip_smoke.py runs the tool on the
built kernels)."""

import importlib.util
import os

import pytest

import torch_parity as tp

_spec = importlib.util.spec_from_file_location(
    "squeeze_sass", os.path.join(tp.REPO, "tools", "squeeze_sass.py"))
sass = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass)

# one step of a made-up walk: left (R10) -> IADD3 -> IMAD.HI -> ISETP ->
# SEL -> left, with an off-chain counter (R20) beside it
STEP = ("IADD3 R10, R10, -R4, RZ",
        "IADD3 R20, R20, 0x1, RZ",
        "IMAD.HI R11, R10, 0x2aaaaaab, RZ",
        "ISETP.GT.AND P0, PT, R11, R5, PT",
        "SEL R10, R11, R6, P0")


def _function(name: str, body) -> str:
    lines = [f"\t\tFunction : {name}",
             '\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
    for i, text in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;"
                     "              /* 0x000fe20000000800 */")
        lines.append("                                                 "
                     "/* 0x000fc40007ffe0ff */")
    return "\n".join(lines)


def _sass(steps: int) -> str:
    walk = (["LDC R1, c[0x0][0x28]", "LDS.128 R4, [R2]"]
            + list(STEP) * steps
            + ["STS.128 [R3], R8", "BRA 0x10", "EXIT"])
    other = ["MOV R2, R3", "IADD3 R2, R2, 0x1, RZ", "EXIT"]
    return (_function("_ZN12_GLOBAL__N_120inv_squeeze_h_kernelEPKiS1_Piiii",
                      walk) + "\n"
            + _function("_ZN12_GLOBAL__N_120inv_squeeze_v_kernelEPKiS1_Piiii",
                        other))


@pytest.mark.parametrize("steps", [8, 32])
def test_chain_of_a_walk(steps):
    funcs = sass.functions(_sass(steps))
    (name,) = [n for n in funcs if "inv_squeeze_h_kernel" in n]
    got = sass.chain(funcs[name])
    assert got["ops_per_step"] == 4 and got["steps_per_period"] == 1
    assert got["by_opcode"] == {"IADD3": 1, "IMAD.HI": 1,
                                "ISETP.GT.AND": 1, "SEL": 1}
    # the LDS that feeds the first step, the chain, the STS of the last
    assert got["path_instructions"] == 4 * steps + 2
    assert got["steps_on_path"] == round((4 * steps + 2) / 4, 1)


def test_a_period_of_two_steps():
    """Steps laid out in pairs (a pair's second step another opcode): the
    period is two steps, found by its two IMAD.HI."""
    other = tuple(t.replace("IADD3 R10,", "LEA R10,") for t in STEP)
    body = (["LDS.128 R4, [R2]"] + list(STEP + other) * 12
            + ["STS.128 [R3], R8", "EXIT"])
    funcs = sass.functions(_function("_Z20inv_squeeze_h_kernelv", body))
    got = sass.chain(next(iter(funcs.values())))
    assert got["steps_per_period"] == 2 and got["ops_per_step"] == 4
    assert got["by_opcode"] == {"IMAD.HI": 2, "ISETP.GT.AND": 2, "SEL": 2,
                                "IADD3": 1, "LEA": 1}


def test_basic_blocks_split_at_branches_and_targets():
    funcs = sass.functions(_sass(8))
    (name,) = [n for n in funcs if "inv_squeeze_h_kernel" in n]
    blocks = sass.basic_blocks(funcs[name])
    # 0x10 (the LDS) is a branch target: LDC | LDS ... BRA | EXIT
    assert [len(b) for b in blocks] == [1, 1 + 5 * 8 + 2, 1]


@pytest.mark.parametrize("text,dests,srcs", [
    ("@!P0 LDS.128 R4, [R2+0x10]", {"R4", "R5", "R6", "R7"},
     {"P0", "R2", "R4", "R5", "R6", "R7"}),
    ("IADD3 R2, P0, R3, R4, RZ", {"R2", "P0"}, {"R3", "R4"}),
    ("SEL R2, R3.reuse, R4, P0", {"R2"}, {"R3", "R4", "P0"}),
    ("STS.64 [R3+0x4], R6", set(), {"R3", "R6", "R7"}),
    ("ISETP.GE.AND P1, PT, R2, UR4, PT", {"P1"}, {"R2", "UR4"}),
    ("IMAD.WIDE R2, R5, 0x4, R8", {"R2", "R3"}, {"R5", "R8"}),
    ("LEA.HI.X R5, R2, R3, R4, 0x2, P0", {"R5"}, {"R2", "R3", "R4", "P0"}),
])
def test_operands(text, dests, srcs):
    ins = sass.Instr(0, text)
    assert ins.dests == dests
    assert ins.srcs == srcs


def test_period():
    assert sass.period(list("abc") * 12) == 3
    assert sass.period(list("x") + list("abcd") * 10 + list("yz")) == 4
    assert sass.period(list("abcdefghijklmnopqrstuvwxyz")) is None
