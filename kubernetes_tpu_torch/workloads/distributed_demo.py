"""Multi-process training demo — the gang-Job payload for the e2e tier.

``python -m kubernetes_tpu_torch.workloads.distributed_demo``

Counterpart of ``kubernetes_tpu/workloads/distributed_demo.py``: the
trainer (:mod:`.trainer`) with ``MODEL=demo`` — rendezvous from
framework env + cluster DNS, the exactly-computable counting loop over
the gang, a checkpoint per step and resume-on-restart. The observable
contract is the reference's: env knobs (TOTAL_STEPS, STEP_DELAY,
CKPT_DIR, KTPU_DEMO_PLATFORM), the ``done-rank<r>-attempt<start>``
files, and the DONE line.
"""
from __future__ import annotations

import os
import sys


def main() -> int:
    os.environ.setdefault("MODEL", "demo")
    from . import trainer
    return trainer.main()


if __name__ == "__main__":
    sys.exit(main())
