"""Repo-wide pytest set-up: build the JAX package's host runtime once.

`shasta_tpu.runtime` compiles `libshasta_host.so` on first use, under a
lock that holds within one process only. Under pytest-xdist each worker
would run its own `g++ -o` into the same file, and a worker that loads the
file half-written skips every test that needs the library. So the xdist
controller (or a run without xdist) builds it here, before any worker
starts; the workers then find the finished library and load it.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        from shasta_tpu import runtime
    except ImportError:  # a checkout without the JAX package
        return
    runtime.available()
