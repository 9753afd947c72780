"""tepdist_tpu_torch — the PyTorch/CUDA port of ``tepdist_tpu``.

A second package beside the JAX one, module for module: ``train.py``
(``plan_training``, with checkpoint ``save``/``restore``),
``runtime/checkpoint.py`` (``CheckpointUtil``, the JAX package's on-disk
format), ``optim.py`` (``sgd``, ``adam``, ``adamw``, ``adamw_bf16``),
``models/`` (``gpt2``, ``llama``, ``gpt_moe``, ``wide_resnet``, ``mlp`` and
``sampling.sample``), ``data/`` (token files and the device prefetcher),
``parallel/sync_free.py``, ``core/``, ``telemetry/`` (the JAX package's
telemetry core) and ``serving/`` (one engine: paged KV cache, chunked
prefill, prefix cache and the supervisor); ``ops/flash_attention.py`` runs
attention on kernels written by hand for Hopper (``csrc/``). It imports
``torch`` and never ``jax`` or ``tepdist_tpu``. Entry points run on the
card (``device="cuda"``) and raise without one; the CPU is used only when
a caller asks for it.
"""

__version__ = "0.1.0"

_LAZY = {
    "plan_training": ("tepdist_tpu_torch.train", "plan_training"),
    "CheckpointUtil": ("tepdist_tpu_torch.runtime.checkpoint",
                       "CheckpointUtil"),
    "sgd": ("tepdist_tpu_torch.optim", "sgd"),
    "adam": ("tepdist_tpu_torch.optim", "adam"),
    "adamw": ("tepdist_tpu_torch.optim", "adamw"),
    "adamw_bf16": ("tepdist_tpu_torch.optim", "adamw_bf16"),
    "make_optimizer": ("tepdist_tpu_torch.optim", "make_optimizer"),
    "sample": ("tepdist_tpu_torch.models.sampling", "sample"),
    "DevicePrefetcher": ("tepdist_tpu_torch.data.prefetch",
                         "DevicePrefetcher"),
    "TokenDataset": ("tepdist_tpu_torch.data.tokens", "TokenDataset"),
    "flash_attention": ("tepdist_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "flash_attention_with_lse": ("tepdist_tpu_torch.ops.flash_attention",
                                 "flash_attention_with_lse"),
    "ServingEngine": ("tepdist_tpu_torch.serving.engine", "ServingEngine"),
    "ServingSupervisor": ("tepdist_tpu_torch.serving.supervisor",
                          "ServingSupervisor"),
    "PagedServableModel": ("tepdist_tpu_torch.serving.paged_kv",
                           "PagedServableModel"),
    "ServableModel": ("tepdist_tpu_torch.serving.kv_cache",
                      "ServableModel"),
}
# Model modules: tepdist_tpu_torch.llama is models/llama.py, and so on.
_MODELS = ("gpt2", "llama", "gpt_moe", "wide_resnet", "mlp", "sampling")


def __getattr__(name):
    """Lazy top-level API, as in ``tepdist_tpu``."""
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _MODELS:
        return importlib.import_module(f"tepdist_tpu_torch.models.{name}")
    raise AttributeError(
        f"module 'tepdist_tpu_torch' has no attribute {name!r}")


__all__ = [*_LAZY, *_MODELS, "__version__"]
