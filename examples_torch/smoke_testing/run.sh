#!/bin/bash
# The port of examples/smoke_testing/run.sh: the client needs no card, the
# server owns the devices. Pass --device cpu to run on the CPU.
set -e
cd "$(dirname "$0")/../.."
python examples_torch/smoke_testing/simple.py --local --steps 10 "$@"
python examples_torch/smoke_testing/attention.py "$@"
python examples_torch/smoke_testing/conv.py "$@"
