#!/bin/bash
# The 4-step pipeline of scripts/run_pipeline.sh on the PyTorch/CUDA port
# (gnn_tumor_seg_tpu_torch): train GNN -> export logits -> train CNN ->
# joint predictions. Data dirs must hold preprocessed samples
# (python -m gnn_tumor_seg_tpu_torch.cli.preprocess). Same environment
# variables as scripts/run_pipeline.sh, plus DEVICE (cuda, the default, or
# cpu), passed as --device to every step.
set -euo pipefail

PROCESSED_TRAINING_DATA_DIR="${PROCESSED_TRAINING_DATA_DIR:?set to preprocessed train dir}"
PROCESSED_TEST_DATA_DIR="${PROCESSED_TEST_DATA_DIR:?set to preprocessed test dir}"
GNN_LOGIT_DIR="${GNN_LOGIT_DIR:?set to logit output dir}"
PRED_OUTPUT_DIR="${PRED_OUTPUT_DIR:?set to prediction output dir}"
LOG_OUTPUT_DIR="${LOG_OUTPUT_DIR:?set to log/checkpoint dir}"
MODEL_NAME="${MODEL_NAME:-pipelineModel}"
MODEL_TYPE="${MODEL_TYPE:-GSpool}"
DEVICE="${DEVICE:-cuda}"
# optional extra CLI args for the train steps (e.g. --hp overrides)
GNN_EXTRA_ARGS="${GNN_EXTRA_ARGS:-}"
CNN_EXTRA_ARGS="${CNN_EXTRA_ARGS:-}"

echo "Starting step 1 of 4: Training GNN"
python -m gnn_tumor_seg_tpu_torch.cli.train_gnn -d "$PROCESSED_TRAINING_DATA_DIR" \
    -o "$LOG_OUTPUT_DIR" -r "${MODEL_NAME}_gnn" -m "$MODEL_TYPE" -k 1 \
    --device "$DEVICE" $GNN_EXTRA_ARGS
echo "Finished step 1"

gnn_weight_file="${LOG_OUTPUT_DIR}/${MODEL_NAME}_gnn_f1.ckpt"
echo "Starting step 2 of 4: Generating GNN Predictions as Logits"
python -m gnn_tumor_seg_tpu_torch.cli.generate_gnn_predictions \
    -d "$PROCESSED_TRAINING_DATA_DIR" -o "$GNN_LOGIT_DIR" -w "$gnn_weight_file" \
    -f logits --device "$DEVICE"
echo "Finished step 2"

echo "Starting step 3 of 4: Training CNN"
python -m gnn_tumor_seg_tpu_torch.cli.train_refinement_cnn \
    -d "$PROCESSED_TRAINING_DATA_DIR" -o "$LOG_OUTPUT_DIR" -l "$GNN_LOGIT_DIR" \
    -r "${MODEL_NAME}_cnn" -k 1 --device "$DEVICE" $CNN_EXTRA_ARGS
echo "Finished step 3"

echo "Starting step 4 of 4: Generating Final Predictions"
cnn_weight_file="${LOG_OUTPUT_DIR}/${MODEL_NAME}_cnn_f1.ckpt"
python -m gnn_tumor_seg_tpu_torch.cli.generate_joint_predictions \
    -d "$PROCESSED_TEST_DATA_DIR" -o "$PRED_OUTPUT_DIR" \
    -c "$cnn_weight_file" -g "$gnn_weight_file" --device "$DEVICE"
echo "Finished Step 4. Predictions Generated"
