"""Static analysis of the engine's plans: the pre-execution plan
verifier (``plan_verifier.py``), counterpart of
``spark_rapids_tpu/analysis/__init__.py``. The reference's tpu-lint
rule engine and lock-order watchdog analyse the JAX package's own
source and have no counterpart here.

Re-exports are lazy so ``python -m
spark_rapids_tpu_torch.analysis.plan_verifier`` does not import the
submodule twice."""

__all__ = ["PlanVerificationError", "PlanVerifier", "VerifyReport",
           "verify_plan"]


def __getattr__(name):
    if name in __all__:
        from . import plan_verifier
        return getattr(plan_verifier, name)
    raise AttributeError(name)
