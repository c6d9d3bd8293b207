"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and ``chip_smoke.py`` fails
(printing no result) where there is no card or no port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / 'src'
PORT_FILES = sorted((SRC / 'repro_torch').rglob('*.py')) + \
    [ROOT / 'chip_smoke.py']


def _forbidden(name: str) -> bool:
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'repro')


def test_port_sources_name_neither_jax_nor_repro():
    bad = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            bad += [f'{path.relative_to(ROOT)}: {n}' for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = f'''
import importlib, importlib.util, pkgutil, sys
sys.modules['jax'] = None
sys.modules['repro'] = None
sys.path.insert(0, {str(SRC)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]
assert not loaded, loaded
print(len(names))
'''
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_fails_without_card_or_port(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['CUDA_VISIBLE_DEVICES'] = ''
    lone = tmp_path / 'chip_smoke.py'
    shutil.copy(ROOT / 'chip_smoke.py', lone)
    for script, cwd in ((ROOT / 'chip_smoke.py', ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
