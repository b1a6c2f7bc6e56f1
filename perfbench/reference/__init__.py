"""The benchmark's plain reference, frozen: copies of jxl_tpu_torch's numpy
and plain-torch container reader, layout, encoder front end, reconstruction
and metric battery, taken when the benchmark was defined, plus a numpy rANS
decode (`values.py`) and the comparisons that decide a run's `correct`
(`judges/`, one judge per coding family). Nothing here imports the program,
so a change to the program cannot move what it is held to."""
