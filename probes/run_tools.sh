#!/usr/bin/env bash
# Run every measurement tool of the port once on cuda:0, each as
# `python -m jxl_tpu_torch.tools.<name> --device cuda:0`, from the repository
# root. Logs and outputs go to the directory given (default
# benchmarks/tools/run, git-ignored); one "<tool> rc=<code> wall=<s>" line per
# tool and the tail of its log are printed. rd_position_report exits 1 where
# matplotlib is missing, after writing its table.
#
#   bash probes/run_tools.sh [OUT_DIR]
set -u
O=${1:-benchmarks/tools/run}
rm -rf "$O"; mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
run() {
  local name=$1; shift
  local t0; t0=$(date +%s.%N)
  timeout 400 python -m jxl_tpu_torch.tools."$name" "$@" > "$O/$name.log" 2>&1
  local rc=$?
  echo "$name rc=$rc wall=$(python -c "print(round($(date +%s.%N) - $t0, 2))")"
  tail -3 "$O/$name.log" | cut -c1-400
}
python -c "from jxl_tpu_torch.bench.headline import synth_kodak; from jxl_tpu_torch.core.io import write_image; write_image('$O/bench.png', synth_kodak())"
run profile_startup --encode "$O/bench.png" --device cuda:0 --out "$O/s1.jxt"; cp "$O/profile_startup.log" "$O/startup_cold_build.log"
run profile_startup --encode "$O/bench.png" --device cuda:0 --out "$O/s2.jxt"; cp "$O/profile_startup.log" "$O/startup_encode.log"
run profile_startup "$O/s2.jxt" --device cuda:0 --out "$O/s2.png"; cp "$O/profile_startup.log" "$O/startup_decode.log"
run profile_stages --device cuda:0
run profile_codec --device cuda:0
run batch_scaling --device cuda:0 --out "$O/batch_scaling.md"
run rd_point --device cuda:0; tail -1 "$O/rd_point.log" > "$O/rd_cur.json"
run rd_tune base 'JXL_TPU_RDO_KAPPA=0.2' --device cuda:0
run rd_bound --device cuda:0
run rd_position_report "$O/rd_cur.json" "$O/rd_cur.json" --device cuda:0 --out "$O/rd_position.md"
run bit_breakdown --device cuda:0 --jpeg
run epf_ab --device cuda:0 --out "$O/epf_ab.md"
run modular_calib "$O/modular_calib.json" --device cuda:0
run hooka_gated_ab --device cuda:0 --out "$O/hooka.md"
run rd_position_corpus --device cuda:0 --out "$O/rd_corpus.md"
run nnz_study --device cuda:0
run ctx_study --device cuda:0
run combo_study --device cuda:0
run make_test_images --device cuda:0 --n 2 --out "$O/mti"
echo done
