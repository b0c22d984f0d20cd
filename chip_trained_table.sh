#!/usr/bin/env bash
# Tables of policies trained by the PyTorch port, each step a process of
# its own.
#
#   bash chip_trained_table.sh               # config 1 (below)
#   bash chip_trained_table.sh a2c-pai-fair  # config 3 (further below)
#
# Config 1: the whole train -> checkpoint -> select -> evaluate loop.
#
# 1. a two-iteration train with a checkpoint and a --resume (a fault in
#    the checkpoint path shows in seconds, not after the long run);
# 2. train ppo-mlp-synth64 on the drain curriculum (--drain-frac 1.0,
#    BASELINE.md's 1,500 iterations), a checkpoint every 250 iterations,
#    6 kept, a held-out drain probe every 100 iterations;
# 3. evaluate the newest checkpoint on held-out seed-123 windows: drained
#    (the drain table), and streaming (zero-shot);
# 4. select_checkpoint over the retained steps on a seed-2000
#    validation stream (test seed 123 refused for validation);
# 5. the full-trace stitched table of the newest and of the selected
#    checkpoint over the seed-123 stream (1,024 jobs).
#
# Config 3 (a2c-pai-fair), BASELINE.md's round-5 recipe: A2C with the
# fairness reward over a 128-slot queue view of 192-job PAI-proxy
# windows, 5,000 iterations, drain curriculum 0.75, windows re-cut every
# 100 iterations, a held-out drain probe every 200 with --keep-best; then
# the fairness table (evaluate --fairness) of the best and of the newest
# checkpoint, and the JCT table of the best, on held-out seed-123 drain
# windows (16 envs x 192 jobs).
#
# Every command's stdout (JSON) and stderr (tables) and its wall time go
# under $OUT (default chiprun_out/trained_table, or
# chiprun_out/trained_table_fair). ITERS, CKPT_EVERY and DEVICE (e.g.
# DEVICE=cpu) cut the run for a rehearsal.
set -euo pipefail
cd "$(dirname "$0")"
MODE=${1:-ppo-mlp-synth64}
if [ "$MODE" = a2c-pai-fair ]; then
    OUT=${OUT:-chiprun_out/trained_table_fair}
    ITERS=${ITERS:-5000}
    CKPT_EVERY=${CKPT_EVERY:-500}
elif [ "$MODE" = ppo-mlp-synth64 ]; then
    OUT=${OUT:-chiprun_out/trained_table}
    ITERS=${ITERS:-1500}
    CKPT_EVERY=${CKPT_EVERY:-250}
else
    echo "unknown mode $MODE (ppo-mlp-synth64 or a2c-pai-fair)" >&2
    exit 2
fi
DEV=${DEVICE:+--device $DEVICE}
CFG="--config ppo-mlp-synth64"
mkdir -p "$OUT"
rm -rf "$OUT/ckpt" "$OUT/smoke"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
if [ -z "${DEVICE:-}" ]; then
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
        | tee "$OUT/card.txt"
fi

run() {   # run NAME ARGS...: python -m rlgpuschedule_tpu_torch.ARGS
    local name=$1; shift
    local t0; t0=$(date +%s.%N)
    python3 -m "rlgpuschedule_tpu_torch.$@" $DEV >"$OUT/$name.jsonl" \
        2>"$OUT/$name.err"
    local t1; t1=$(date +%s.%N)
    echo "{\"command\": \"$name\", \"wall_s\": $(python3 -c "print($t1 - $t0)")}" \
        | tee -a "$OUT/walls.jsonl"
    tail -n 1 "$OUT/$name.jsonl" | cut -c1-2000
}

if [ "$MODE" = a2c-pai-fair ]; then
    FAIR="--config a2c-pai-fair --queue-len 128 --window-jobs 192"
    run smoke_train train $FAIR --drain-frac 0.75 --iterations 2 \
        --ckpt-dir "$OUT/smoke" --ckpt-every 1 --log-every 1
    run smoke_resume train $FAIR --drain-frac 0.75 --iterations 1 \
        --ckpt-dir "$OUT/smoke" --resume --log-every 1
    run train train $FAIR --drain-frac 0.75 --resample-every 100 \
        --iterations "$ITERS" --ckpt-dir "$OUT/ckpt" \
        --ckpt-every "$CKPT_EVERY" --ckpt-keep 3 --log-every 100 \
        --eval-every 200 --keep-best
    run fair_best evaluate $FAIR --ckpt-dir "$OUT/ckpt/best" --seed 123 \
        --drain-frac 1.0 --fairness
    run fair_newest evaluate $FAIR --ckpt-dir "$OUT/ckpt" --seed 123 \
        --drain-frac 1.0 --fairness
    run jct_best evaluate $FAIR --ckpt-dir "$OUT/ckpt/best" --seed 123 \
        --drain-frac 1.0 --percentiles
    ls -l "$OUT/ckpt" "$OUT/ckpt/best" > "$OUT/ckpt_listing.txt"
    echo "trained table (a2c-pai-fair): done"
    exit 0
fi

run smoke_train train $CFG --drain-frac 1.0 --iterations 2 \
    --ckpt-dir "$OUT/smoke" --ckpt-every 1 --log-every 1
run smoke_resume train $CFG --drain-frac 1.0 --iterations 1 \
    --ckpt-dir "$OUT/smoke" --resume --log-every 1

run train train $CFG --drain-frac 1.0 --iterations "$ITERS" \
    --ckpt-dir "$OUT/ckpt" --ckpt-every "$CKPT_EVERY" --ckpt-keep 6 \
    --log-every 50 --eval-every 100 --eval-windows 8

run eval_drain evaluate $CFG --ckpt-dir "$OUT/ckpt" --seed 123 \
    --drain-frac 1.0 --percentiles
run eval_drain64 evaluate $CFG --ckpt-dir "$OUT/ckpt" --seed 123 \
    --drain-frac 1.0 --eval-windows 64
run eval_stream64 evaluate $CFG --ckpt-dir "$OUT/ckpt" --seed 123 \
    --eval-windows 64

run select select_checkpoint $CFG --ckpt-dir "$OUT/ckpt" --test-seed 123
STEP=$(tail -n 1 "$OUT/select.jsonl" | python3 -c \
    'import json, sys; print(json.load(sys.stdin)["step"])')

run full_trace_drain1 evaluate $CFG --ckpt-dir "$OUT/ckpt" --seed 123 \
    --full-trace --stitch-drain-jobs 1 --no-random --percentiles
run full_trace_drain8 evaluate $CFG --ckpt-dir "$OUT/ckpt" --seed 123 \
    --full-trace --stitch-drain-jobs 8 --percentiles
run full_trace_selected evaluate $CFG --ckpt-dir "$OUT/ckpt" \
    --ckpt-step "$STEP" --seed 123 --full-trace --stitch-drain-jobs 8 \
    --no-random --percentiles
ls -l "$OUT/ckpt" > "$OUT/ckpt_listing.txt"
echo "trained table: done"
