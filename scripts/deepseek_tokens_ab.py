"""Greedy tokens of chip_smoke.py's deepseek-v2-lite-16b engine phase in
this checkout against another checkout's (for example the parent commit,
unpacked with ``git archive``): full width, random bf16 weights from
chip_smoke's seed, two waves of 4 requests through the paged pool, every
attend through ``paged_attention_mla``. Each checkout runs in a subprocess
of its own, with its own kernels. Prints whether the 8 requests' tokens are
equal and, where they are not, the first request and position that
differ; exits 1 if they differ. Needs one CUDA card.

    python3 scripts/deepseek_tokens_ab.py OTHER_CHECKOUT
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def dump(root: Path) -> None:
    """In the subprocess: run ``root``'s phase and print its tokens."""
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
    smoke.phase_paged(get_config(smoke.DS), 'deepseek', 'paged_attention_mla')
    print(json.dumps(tokens[0]), flush=True)


def run(root: Path) -> list:
    out = subprocess.run([sys.executable, __file__, '--dump', str(root)],
                         capture_output=True, text=True, cwd=root)
    if out.returncode:
        raise SystemExit(f'{root}: exit {out.returncode}\n{out.stderr}')
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        if '[deepseek]' in line or '[device]' in line:
            print(f'{root.name}: {line}', flush=True)
    return json.loads(lines[-1])


def main() -> int:
    if sys.argv[1] == '--dump':
        dump(Path(sys.argv[2]).resolve())
        return 0
    other = Path(sys.argv[1]).resolve()
    mine, theirs = run(ROOT), run(other)
    diff = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
            for i, (x, y) in enumerate(zip(mine, theirs)) if x != y]
    print(json.dumps({'requests': len(mine),
                      'tokens': sum(map(len, mine)),
                      'equal': mine == theirs,
                      'first_differences': diff}), flush=True)
    return 0 if mine == theirs else 1


if __name__ == '__main__':
    sys.exit(main())
