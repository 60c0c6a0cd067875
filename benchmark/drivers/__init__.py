"""One driver a kind of traffic, named by a workload file's ``driver``."""
