#!/bin/bash
# The whole BitDistiller pipeline for a 7B model at int2-g128 through the
# port's CLI on one NVIDIA card: the stages and flags of the JAX package's
# scripts/train_7b_int2.sh. Run from the repo root:
#   bash bitdistiller_tpu_torch/scripts/train_7b_int2.sh <hf-model-dir> [out-dir]
set -euo pipefail

MODEL=${1:?usage: train_7b_int2.sh <hf-model-dir> [out-dir]}
OUT=${2:-./artifacts/$(basename "$MODEL")-int2-g128}
BITS=2
GROUP=128
mkdir -p "$OUT"

echo "== stage 1: asymmetric clip search =="
python -m bitdistiller_tpu_torch.cli autoclip \
  --model_path "$MODEL" --w_bit $BITS --q_group_size $GROUP \
  --quant_type int --dump_clip "$OUT/clip.npz" \
  --calib_dataset pile --n_samples 128 --seqlen 1024

echo "== stage 2: teacher data self-generation =="
python -m bitdistiller_tpu_torch.cli generate \
  --base_model "$MODEL" --dataset_name alpaca \
  --out_path "$OUT/teacher.jsonl" --max_sample 5000 \
  --temperature 0.7 --max_new_tokens 1024 --max_batch 16

echo "== stage 3: CAKLD KD-QAT =="
python -m bitdistiller_tpu_torch.cli train \
  --model_name_or_path "$MODEL" --data_path "$OUT/teacher.jsonl" \
  --output_dir "$OUT/trained" \
  --bits $BITS --q_group_size $GROUP --quant_type int2-asym \
  --clip "$OUT/clip.npz" --kd_loss_type cakld --cakld_steps 10 \
  --per_device_train_batch_size 2 --gradient_accumulation_steps 8 \
  --learning_rate 8e-6 --num_train_epochs 1 --model_max_length 2048 \
  --save_steps 400 --eval_steps 200

echo "== eval: WikiText-2 PPL =="
python -m bitdistiller_tpu_torch.cli ppl \
  --model_path "$OUT/trained" --quant_type int --w_bit $BITS --q_group_size $GROUP

echo "== pack for serving =="
python -m bitdistiller_tpu_torch.cli pack \
  --model_path "$OUT/trained" --w_bit $BITS --q_group_size $GROUP \
  --output "$OUT/packed"

echo "done: $OUT"
