"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port either. Top-level module names are
compared whole (the part before the first dot), so `jxl_oxide_tpu_torch`
is not `jxl_oxide_tpu`."""

import ast
import os
import subprocess
import sys
import textwrap

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "jxl_oxide_tpu")

IMPORT_ALL = textwrap.dedent("""
    import importlib, importlib.util, os, sys
    refused = set(sys.argv[2].split(","))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in refused:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, os.path.dirname(sys.argv[1]))
    for path in sys.argv[3:]:
        rel = os.path.relpath(path, os.path.dirname(sys.argv[1]))[:-3]
        parts = rel.split(os.sep)
        pkg = all(os.path.exists(os.path.join(
            os.path.dirname(sys.argv[1]), *parts[:i], "__init__.py"))
            for i in range(1, len(parts)))
        if pkg and "." not in parts[-1]:
            importlib.import_module(".".join(p for p in parts
                                             if p != "__init__"))
            continue
        name = "_".join(parts).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    print(sorted({m.split(".")[0] for m in sys.modules} & refused))
""")


def modules(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(PB, sub)):
        out += [os.path.join(d, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def import_all(paths, refused):
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL, PB, ",".join(refused), *paths],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines()[-1]


def test_every_module_imports_without_jax_or_the_jax_package():
    paths = modules()
    assert len(paths) > 20
    assert import_all(paths, FORBIDDEN) == "[]"


def test_the_reference_imports_nothing_of_the_port():
    refs = modules("reference")
    assert refs
    assert import_all(refs, FORBIDDEN + ("jxl_oxide_tpu_torch",)) == "[]"
    for path in refs:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN + (
                    "jxl_oxide_tpu_torch",), (path, n)


def test_the_finder_compares_whole_top_level_names():
    probe = os.path.join(ROOT, "jxl_oxide_tpu_torch", "utils", "errors.py")
    # a module of the port loads under the JAX package's name refused
    assert import_all([probe], FORBIDDEN) == "[]"
    bad = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL + "\nimport jxl_oxide_tpu\n", PB,
         ",".join(FORBIDDEN)], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert bad.returncode != 0 and "refused import of jxl_oxide_tpu" in bad.stderr
