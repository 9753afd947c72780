#!/bin/bash
# System-level smoke of every example of the PyTorch port on the CPU: each
# line of scripts/run_examples.sh, run through examples_torch/ with
# --device cpu (the examples run on the card by default).
set -e
cd "$(dirname "$0")/.."
D="--device cpu"

echo "== smoke_testing =="
python examples_torch/smoke_testing/simple.py --local --steps 3 $D
python examples_torch/smoke_testing/attention.py $D
python examples_torch/smoke_testing/conv.py $D

echo "== GPT2 (auto plan / pipeline / collective pipeline) =="
python examples_torch/GPT2/main.py --config test --batch 8 --seq 32 \
    --steps 2 $D
python examples_torch/GPT2/main.py --config test --batch 8 --seq 32 \
    --steps 2 --num_stages 2 --num_micro_batches 2 $D
python examples_torch/GPT2/main.py --config test --batch 8 --seq 32 \
    --steps 2 --num_stages 2 --num_micro_batches 2 --pipeline collective $D

echo "== generate (sampling over RPC, server-held weights) =="
python examples_torch/GPT2/generate.py --local --config test --steps 2 \
    --max_new_tokens 8 --temperature 0.8 --top_k 20 $D

echo "== PP x TP (stage x model nesting, config mode) =="
INTRA_STAGE_TP=2 VAR_MEM_LIMIT=$((6<<20)) \
python examples_torch/GPT2/main.py --config test --batch 8 --seq 32 \
    --steps 2 --num_stages 2 --num_micro_batches 2 $D

echo "== long context (ring / ulysses) =="
python examples_torch/GPT2/long_context.py --config test --batch 2 \
    --seq 64 --steps 2 --impl ring $D
python examples_torch/GPT2/long_context.py --config test --batch 2 \
    --seq 64 --steps 2 --impl ulysses $D

echo "== wide_resnet =="
python examples_torch/wide_resnet/train_imagenet.py --model_type -1 \
    --batch 16 --image_size 32 --steps 2 $D

echo "== llama (einsum + flash attention) =="
python examples_torch/llama/train.py --config test --batch 4 --seq 32 \
    --steps 2 $D
python examples_torch/llama/train.py --config test --batch 4 --seq 32 \
    --steps 2 --attn flash $D

echo "== gpt_moe =="
python examples_torch/gpt_moe/pretrain_gpt_moe.py --config test \
    --batch 4 --seq 32 --steps 2 $D

echo "== auto_explore (fully automatic service-side planning) =="
python examples_torch/auto_explore/main.py --steps 2 $D
python examples_torch/auto_explore/main.py --steps 2 --regime pipeline $D

echo "ALL EXAMPLES OK"
