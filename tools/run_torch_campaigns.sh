#!/bin/bash
# The port's training campaigns on one GPU: kgat_tpu's evidence runs
# (tools/campaigns.md, tools/run_evidence.sh, tools/run_r5_phase2.sh) with
# `python -m kgat_tpu_torch.<module>` in place of `python -m
# kgat_tpu.<module>`, the run names prefixed `torch-`, and nothing else
# changed. Run from the repository root:
#
#     tools/run_torch_campaigns.sh STAGE...
#
# STAGE is one of: mid-plateau (seeds 1234, 1, 2), ab-pretrain, smoke-gcn,
# yelp2018-files (seeds 1234, 1, 2), lastfm-bi-ev, amazon-graphsage-ev,
# amazon-c6-cold. The
# last four read the synthetic exports at the Makefile's published sizes,
# which the port's synthetic_dataset / save_dataset write into datasets/
# when they are missing. Each run logs to runs/torch-<name>$SUFFIX.jsonl
# ($SUFFIX default empty; "-co" names the runs at the coalesced, bf16-
# rounded defaults apart from earlier ones). A run
# whose log exists without a `done` event continues with --resume (the
# log appends); a finished run is skipped. Each log, and the pretrain
# npz, is copied into $OUT (default runs/tmp, gitignored) as it ends,
# with the run's output in $OUT/<name>.log: on a machine whose files do
# not outlive the command, point OUT at the directory that comes back.
# Stage time limits: $LIMIT seconds each (default 1800). Exits with the
# number of runs that failed.
set -u
cd "$(dirname "$0")/.."
OUT=${OUT:-runs/tmp}
LIMIT=${LIMIT:-1800}
SUFFIX=${SUFFIX:-}
mkdir -p runs "$OUT"
failed=0

note() { echo "[campaigns $(date -u +%H:%M:%S)] $*"; }

# export NAME: the Makefile's `make datasets` sizes, by the port's writer.
export_dataset() {
  [ -f "datasets/$1/kg_final.txt" ] && return 0
  note "writing datasets/$1"
  python -c "import sys
from kgat_tpu_torch.data import save_dataset, synthetic_dataset
u, i, e, r, n, t = {
    'amazon-book': (70679, 24915, 88572, 39, 847733, 2557746),
    'last-fm': (23566, 48123, 58266, 9, 3034796, 464567),
    'yelp2018': (45919, 45538, 90961, 42, 1185068, 1853704)}[sys.argv[1]]
save_dataset(synthetic_dataset(seed=0, n_users=u, n_items=i, n_entities=e,
                               n_relations_kg=r, n_interactions=n,
                               n_triples=t, name=sys.argv[1]), 'datasets')
" "$1"
}

# run NAME ARGS...: one trainer run, continued with --resume if its log
# exists unfinished.
run() {
  local name=$1$SUFFIX; shift
  local log="runs/$name.jsonl" extra=()
  if [ -f "$log" ] && grep -q '"event": "done"' "$log"; then
    note "$name: done already"; return 0
  fi
  [ -f "$log" ] && extra=(--resume)
  note "$name: start ${extra[*]}"
  timeout -k 30 "$LIMIT" python -m kgat_tpu_torch.train "$@" \
    --run-name "$name" "${extra[@]}" >> "$OUT/$name.log" 2>&1
  local rc=$?
  note "$name: rc=$rc"
  [ -f "$log" ] && cp "$log" "$OUT/"
  [ $rc -eq 0 ] || failed=$((failed + 1))
}

MID=(--dataset synthetic --syn-users 3000 --syn-items 2000
     --syn-entities 4000 --syn-relations 8 --syn-interactions 60000
     --syn-triples 40000 --ops-backend pallas --compute-dtype bf16
     --lr 1e-3 --epochs 300 --eval-every 5)

for stage in "$@"; do
  case $stage in
    mid-plateau)
      for seed in 1234 1 2; do
        run "torch-mid-plateau-s$seed" "${MID[@]}" --seed "$seed"
      done ;;
    ab-pretrain)
      if [ ! -f runs/torch-ab-mf.npz ]; then
        note "torch-ab-mf: BPR-MF pretrain"
        timeout -k 30 "$LIMIT" python -m kgat_tpu_torch.models.bprmf \
          --dataset synthetic --out runs/torch-ab-mf.npz --epochs 60 \
          > "$OUT/torch-ab-mf.log" 2>&1 || failed=$((failed + 1))
      fi
      cp runs/torch-ab-mf.npz "$OUT/" 2>/dev/null
      run torch-ab-pretrain --dataset synthetic --ops-backend pallas \
        --compute-dtype bf16 --lr 1e-3 --use-pretrain runs/torch-ab-mf.npz \
        --epochs 30 --eval-every 5 ;;
    smoke-gcn)
      run torch-smoke-gcn --preset smoke-gcn ;;
    yelp2018-files)
      export_dataset yelp2018 || failed=$((failed + 1))
      run torch-yelp2018-files --dataset yelp2018 --data-root datasets \
        --ops-backend pallas --compute-dtype bf16 --epochs 2 \
        --eval-every 2 --graph-cache runs/gcache
      for seed in 1 2; do
        run "torch-yelp2018-files-s$seed" --dataset yelp2018 \
          --data-root datasets --ops-backend pallas --compute-dtype bf16 \
          --epochs 2 --eval-every 2 --graph-cache runs/gcache --seed "$seed"
      done ;;
    lastfm-bi-ev)
      export_dataset last-fm || failed=$((failed + 1))
      run torch-lastfm-bi-ev --preset lastfm-bi --compute-dtype bf16 \
        --epochs 5 --eval-every 5 --graph-cache runs/gcache ;;
    amazon-graphsage-ev)
      export_dataset amazon-book || failed=$((failed + 1))
      run torch-amazon-graphsage-ev --preset amazon-graphsage \
        --compute-dtype bf16 --epochs 15 --eval-every 5 \
        --graph-cache runs/gcache ;;
    amazon-c6-cold)
      export_dataset amazon-book || failed=$((failed + 1))
      run torch-amazon-c6-cold --dataset amazon-book --ops-backend pallas \
        --compute-dtype bf16 --epochs 20 --eval-every 5 \
        --graph-cache runs/gcache ;;
    *)
      echo "unknown stage $stage" >&2; failed=$((failed + 1)) ;;
  esac
done
note "failed runs: $failed"
exit "$failed"
