"""WideResNet data-parallel benchmark with fake input: the port of
``examples/wide_resnet/train_imagenet.py`` (model_type 0-6 and the -1
test config; fake data only, as the reference's README says of its
benchmark). Plans over the process group's ranks
(``examples_torch/common.py``)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_type", type=int, default=0)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--steps", type=int, default=10)
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None):
    """Train as the JAX example does; ``params`` and ``batch`` ((images,
    labels)) default to the port's seeded init and fake batch. Returns
    the printed numbers."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
    from tepdist_tpu_torch.models import wide_resnet as wrn
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    cfg = wrn.CONFIGS[args.model_type]
    if params is None:
        params = wrn.init_params(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.to(dev), params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    common.rank0_print(f"WRN model_type={args.model_type}: "
                       f"{n_params/1e6:.0f}M params")
    if batch is None:
        batch = wrn.fake_batch(cfg, args.batch, args.image_size, device=dev)
    images, labels = (t.to(dev) for t in batch)
    tx = sgd(0.1, momentum=0.9)
    opt_state = tx.init(params)
    grad_fn = value_and_grad(lambda p, i, l: wrn.loss_fn(p, i, l, cfg))

    def train_step(params, opt_state, images, labels):
        loss, grads = grad_fn(params, images, labels)
        return loss, params, tx.apply(params, grads, opt_state)

    with common.world(dev) as n:
        n_state = len(tree_leaves((params, opt_state)))
        plan = auto_parallel(train_step, MeshTopology([("data", n)]),
                             params, opt_state, images, labels,
                             state_alias={1 + k: k for k in range(n_state)})

        def line(i, loss, dt):
            return f"step {i}: loss={loss:.4f} ({args.batch/dt:.1f} images/s)"

        res = common.run_lowered(plan, (params, opt_state), [images, labels],
                                 args.steps, dev, line)
    return {"n_params": n_params, **res}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
