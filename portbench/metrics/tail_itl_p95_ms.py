"""Session scheduler: the 95th percentile of inter-token gaps over the
window, read as the end-to-end ``itl_p95_ms`` reads it, in the cells whose
runs spread too widely for it to stand under a bound (the host paces
them)."""
from portbench.harness.spec import metric_reader

read = metric_reader("itl_p95_ms").read
