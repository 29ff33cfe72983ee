"""Fault-injection arming: one process-global plan, read by every seam.

Counterpart of ``hadoop_bam_tpu/faults/__init__.py``.  The seams (the
executor's attempt, ``spec/bgzf.inflate_block``'s CRC gate, the codec's
member tier-downs) each check ``faults.ACTIVE is not None``, one module
attribute read, before doing anything, so a disarmed process pays no
measurable cost and counts nothing.

Arming, in precedence order:

1. ``HBAM_FAULTS`` at import time (covers subprocesses: the ``kill -9``
   drills arm their children this way);
2. the ``hadoopbam.faults.plan`` conf key through :func:`arm_from_conf`;
3. :func:`arm` directly.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from .plan import Directive, FaultPlan, InjectedResourceExhausted

__all__ = ["ACTIVE", "Directive", "FaultPlan", "InjectedResourceExhausted",
           "arm", "arm_from_conf", "arm_from_env", "disarm"]

#: The armed plan, or None (the common case: seams check this and stop).
ACTIVE: Optional[FaultPlan] = None


def arm(plan: Union[FaultPlan, str]) -> FaultPlan:
    """Arm a plan (or parse and arm a spec string) process-wide."""
    global ACTIVE
    ACTIVE = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def arm_from_env() -> bool:
    """Arm from ``HBAM_FAULTS`` if set; returns whether a plan armed."""
    spec = os.environ.get("HBAM_FAULTS")
    if spec:
        arm(spec)
        return True
    return False


def arm_from_conf(conf) -> bool:
    """Arm from the ``hadoopbam.faults.plan`` conf key unless a plan is
    already armed (the environment's wins); returns whether a plan is
    armed after the call."""
    if ACTIVE is not None:
        return True
    from ..conf import FAULTS_PLAN

    spec = conf.get(FAULTS_PLAN) if conf is not None else None
    if spec:
        arm(spec)
        return True
    return False


arm_from_env()
