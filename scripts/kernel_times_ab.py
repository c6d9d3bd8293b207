"""Phase 3's checks and times of ``gather_rope``, ``fused_page_write`` and
``cow_page_copy`` (and the launch floor) in this checkout against another
checkout's (for
example the parent commit, unpacked with ``git archive``), in one call on
one card: each checkout's own ``chip_smoke.py`` functions run in a
subprocess of their own, with their own kernels, in the order other, this,
this, other. Prints every ``[kernel]`` line tagged with its checkout and
round; exits 1 if a checkout's checks fail.

    python3 scripts/kernel_times_ab.py OTHER_CHECKOUT
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKS = ('check_gather_rope', 'check_fused_page_write',
          'check_cow_page_copy', 'check_mla_page_writes',
          'check_quant_page_writes')


def checks(root: Path) -> None:
    """In the subprocess: ``root``'s phase 3 checks of the three
    kernels."""
    sys.path[:0] = [str(root), str(root / 'src')]
    import torch
    import chip_smoke as smoke
    smoke.phase_device()
    smoke.build.build_all(['gather_rope', 'fused_page_write',
                           'cow_page_copy', 'launch_floor'])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(smoke.SEED)
    smoke.launch_floor_ms()
    for name in CHECKS:
        getattr(smoke, name)(gen)
        smoke.free()


def main() -> int:
    if sys.argv[1] == '--checks':
        checks(Path(sys.argv[2]).resolve())
        return 0
    other = Path(sys.argv[1]).resolve()
    failed = 0
    for i, root in enumerate((other, ROOT, ROOT, other)):
        out = subprocess.run([sys.executable, __file__, '--checks',
                              str(root)], capture_output=True, text=True,
                             cwd=root)
        tag = f'{"this" if root == ROOT else "other"} round {i // 2 + 1}'
        for line in out.stdout.splitlines():
            if line.startswith(('[kernel]', '[device]')):
                print(f'{tag}: {line}', flush=True)
        if out.returncode:
            failed = 1
            print(f'{tag}: exit {out.returncode}\n{out.stderr[-4000:]}',
                  flush=True)
    return failed


if __name__ == '__main__':
    sys.exit(main())
