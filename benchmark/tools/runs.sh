#!/bin/bash
# Runs of the benchmark one after another, from the root of a checkout:
#   bash benchmark/tools/runs.sh TAG "cell trace control seconds seed" ...
# Each run's standard output and error go to chiprun_out/TAG.N.out / .err;
# the end of each is echoed (the result line, the window and the checks).
tag=$1; shift
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
i=0
for a in "$@"; do set -- $a; i=$((i+1))
  echo "== $tag.$i cell=$1 trace=$2 control=$3 seconds=$4 seed=$5 t=$SECONDS"
  python3 benchmark/run.py --workload "$1" --seed "$5" --seconds "$4" \
    --trace "$2" --control "$3" > "chiprun_out/$tag.$i.out" \
    2> "chiprun_out/$tag.$i.err"
  echo "rc=$? t=$SECONDS"
  tail -n 1 "chiprun_out/$tag.$i.out" | cut -c1-1500
  grep -E "particles|peak after|window:|cross-check|checking|^check|took|gap .* limit|Error|error" \
    "chiprun_out/$tag.$i.err" | cut -c1-400 | tail -14
done
