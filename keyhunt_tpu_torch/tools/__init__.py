"""Stand-alone measurement tools of the port (`bench_vpu`)."""
