"""The benchmark of jxl_tpu_torch: `python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`, driven by BENCHMARK.json."""
