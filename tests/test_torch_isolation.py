"""The port stands alone: jxl_oxide_tpu_torch (its encoders/ too) and
chip_smoke.py import neither JAX nor the JAX package (jxl_oxide_tpu),
which the machine with the card does not have."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

import torch_parity as tp

FORBIDDEN = ("jax", "jaxlib", "jxl_oxide_tpu")


def _sources():
    files = sorted(glob.glob(os.path.join(tp.REPO, "jxl_oxide_tpu_torch",
                                          "**", "*.py"), recursive=True))
    return files + [os.path.join(tp.REPO, "chip_smoke.py")]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, tp.REPO))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_decode_loads_no_jax_module():
    """A whole decode in a fresh interpreter leaves no jax or
    jxl_oxide_tpu module in sys.modules."""
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {tp.REPO!r})\n"
        "from jxl_oxide_tpu_torch import JxlImage\n"
        f"data = open({os.path.join(tp.TESTDATA, 'epf3_512.jxl')!r}, "
        "'rb').read()\n"
        "u8 = JxlImage.from_bytes(data, device='cpu').render_frame(0)"
        ".to_u8()\n"
        "print(json.dumps({'shape': list(u8.shape), 'modules': sorted("
        "m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=tp.REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [512, 512, 3]
    assert res["modules"] == []


def test_encoders_load_no_jax_module():
    """The port's encoders (encoders/) in a fresh interpreter: an XYB
    VarDCT stream, a squeezed Modular one and the CLI's generate-fixture
    leave no jax or jxl_oxide_tpu module in sys.modules."""
    script = (
        "import json, sys, tempfile, os\n"
        f"sys.path.insert(0, {tp.REPO!r})\n"
        "import numpy as np\n"
        "from jxl_oxide_tpu_torch import cli\n"
        "from jxl_oxide_tpu_torch.encoders.encoder import "
        "encode_jxl_modular\n"
        "from jxl_oxide_tpu_torch.encoders.encoder_vardct import "
        "encode_jxl_vardct\n"
        "rng = np.random.default_rng(0)\n"
        "a = encode_jxl_vardct(rng.random((32, 40, 3)).astype(np.float32), "
        "xyb=True, gabor=True, epf_iters=2)\n"
        "b = encode_jxl_modular([rng.integers(0, 256, (32, 40)) for _ in "
        "range(3)], bit_depth=8, squeeze=True, rct=True)\n"
        "out = os.path.join(tempfile.mkdtemp(), 'g.jxl')\n"
        "rc = cli.main(['generate-fixture', '-o', out, '--kind', 'vardct'])\n"
        "print(json.dumps({'rc': rc, 'sizes': [len(a), len(b)], 'modules': "
        "sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=tp.REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and min(res["sizes"]) > 0
    assert res["modules"] == []
