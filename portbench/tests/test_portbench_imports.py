"""Nothing under portbench/ imports JAX or the JAX package, or reads the
JAX package's benchmark or the smoke; the references import nothing of
the program. Top-level module names are compared whole: topk_rec_torch
and topk_rec_tpu share a prefix."""

import os
import re
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "topk_rec_tpu")


def modules():
    """Dotted names of every module under portbench/ but its tests."""
    out = []
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
                out.append(rel.replace(os.sep, "."))
    return sorted(out)


def run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def block(names):
    """Code that makes importing any module under ``names`` fail."""
    return (
    "import sys, importlib, importlib.util\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in %r:\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.path.insert(0, %r)\n" % (tuple(names), ROOT))


def test_every_module_imports_with_jax_blocked():
    mods = [m for m in modules() if "." in m and
            not m.startswith("portbench.metrics.")]
    metric_files = [os.path.join(BENCH, "metrics", f)
                    for f in os.listdir(os.path.join(BENCH, "metrics"))
                    if f.endswith(".py")]
    code = block(FORBIDDEN) + (
        "for m in %r:\n    importlib.import_module(m)\n"
        "for i, p in enumerate(%r):\n"
        "    spec = importlib.util.spec_from_file_location('m%%d' %% i, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\nprint('ok', len(sys.modules))\n"
        % (mods, metric_files, FORBIDDEN))
    r = run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


def test_reference_imports_nothing_of_the_program():
    code = block(FORBIDDEN + ("topk_rec_torch",)) + (
        "import importlib\n"
        "for m in ('portbench.reference.pairwise', 'portbench.reference.topk',"
        " 'portbench.reference.protocol', 'portbench.reference.precision'):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('topk_rec_torch',) + %r]\n"
        "assert not bad, bad\nprint('ok')\n" % (FORBIDDEN,))
    r = run(code)
    assert r.returncode == 0, r.stderr[-2000:]


def test_no_import_lines_of_jax_or_the_old_benchmark():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|topk_rec_tpu|"
                     r"bench|benchmarks|chip_smoke)\b")
    ref = re.compile(r"^\s*(import|from)\s+topk_rec_torch\b")
    # a path to the old benchmark or the smoke in a string literal
    literal = re.compile(r"[\"']([^\"'\s]*/)?(bench\.py|chip_smoke(\.py)?|"
                         r"benchmarks)(/[^\"'\s]*)?[\"']")
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            text = open(path).read()
            for ln in text.splitlines():
                assert not pat.match(ln), (path, ln)
                if os.sep + "reference" + os.sep in path:
                    assert not ref.match(ln), (path, ln)
            assert not literal.search(text), (path, literal.search(text))
