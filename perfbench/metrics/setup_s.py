"""The run's set-up, from the process's first statement to the end of
the cell's warm-up (imports, CUDA context, libraries, scene compile,
warm-up; in the traced run also the work count and the profiler's
start), less the seconds the frozen reference took to make the inputs
(the inverse cell's target), in seconds."""


def read(record):
    return record["setup_s"]
