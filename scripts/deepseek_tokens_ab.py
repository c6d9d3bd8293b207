"""Greedy tokens of chip_smoke.py's deepseek-v2-lite-16b engine phase (or,
with ``glm4``, of its glm4-9b bf16 and int8 runs) in this checkout against
another checkout's (for example the parent commit, unpacked with ``git
archive``): full width, random bf16 weights from chip_smoke's seed, two
waves of 4 requests through the paged pool, every attend through
``paged_attention_mla`` (glm4: ``paged_attention``, then
``paged_attention_quant`` over the int8 pool). Each checkout runs in a
subprocess of its own, with its own kernels. Prints for each run whether
the 8 requests' tokens are equal and, where they are not, the first
request and position that differ; exits 1 if any differ. Needs one CUDA
card.

    python3 scripts/deepseek_tokens_ab.py OTHER_CHECKOUT [glm4]
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def dump(root: Path, arch: str) -> None:
    """In the subprocess: run ``root``'s phase and print its runs' tokens."""
    sys.path[:0] = [str(root), str(root / 'src')]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    smoke.phase_device()
    tokens = []
    serve = smoke.serve_waves

    def keep(*args, **kwargs):
        out = serve(*args, **kwargs)
        tokens.append(out[1])
        return out
    smoke.serve_waves = keep
    if arch == 'glm4':
        smoke.phase_paged(get_config('glm4_9b'), 'glm4', 'paged_attention',
                          int8=True)
    else:
        smoke.phase_paged(get_config(smoke.DS), 'deepseek',
                          'paged_attention_mla')
    print(json.dumps(tokens), flush=True)


def run(root: Path, arch: str) -> list:
    out = subprocess.run([sys.executable, __file__, '--dump', str(root),
                          arch], capture_output=True, text=True, cwd=root)
    if out.returncode:
        raise SystemExit(f'{root}: exit {out.returncode}\n{out.stderr}')
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        if f'[{arch}' in line or '[device]' in line:
            print(f'{root.name}: {line}', flush=True)
    return json.loads(lines[-1])


def main() -> int:
    if sys.argv[1] == '--dump':
        dump(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    other = Path(sys.argv[1]).resolve()
    arch = sys.argv[2] if len(sys.argv) > 2 else 'deepseek'
    mine, theirs = run(ROOT, arch), run(other, arch)
    for k, (a, b) in enumerate(zip(mine, theirs)):
        diff = [(i, next(j for j, (u, w) in enumerate(zip(x, y)) if u != w))
                for i, (x, y) in enumerate(zip(a, b)) if x != y]
        print(json.dumps({'arch': arch, 'run': k, 'requests': len(a),
                          'tokens': sum(map(len, a)), 'equal': a == b,
                          'first_differences': diff}), flush=True)
    return 0 if mine == theirs else 1


if __name__ == '__main__':
    sys.exit(main())
