"""tepdist_tpu_torch — the PyTorch/CUDA port of ``tepdist_tpu``.

A second package beside the JAX one, module for module: ``models/gpt2.py``,
``optim.py``, ``parallel/sync_free.py`` and ``train.py`` mirror their JAX
counterparts, and ``ops/flash_attention.py`` runs attention on kernels
written by hand for Hopper (``csrc/``). It imports ``torch`` and never
``jax`` or ``tepdist_tpu``. Entry points run on the card (``device="cuda"``)
and raise without one; the CPU is used only when a caller asks for it.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API, as in ``tepdist_tpu``."""
    lazy = {
        "plan_training": ("tepdist_tpu_torch.train", "plan_training"),
        "flash_attention": ("tepdist_tpu_torch.ops.flash_attention",
                            "flash_attention"),
        "flash_attention_with_lse": (
            "tepdist_tpu_torch.ops.flash_attention",
            "flash_attention_with_lse"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'tepdist_tpu_torch' has no attribute {name!r}")


__all__ = ["plan_training", "flash_attention", "flash_attention_with_lse",
           "__version__"]
