#!/bin/bash
# CI entry points (the reference curates its CI the same way,
# tools/ci/run_fa4_ci.py). Run from the repo root.
set -e
case "${1:-smoke}" in
  smoke)   # every subsystem on the CPU
    JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow" -n 4 ;;
  full)    # + breadth sweeps and heavy scenarios
    JAX_PLATFORMS=cpu python -m pytest tests/ -q -n 4 ;;
  chip)    # the main paths on one GPU (exits non-zero without one)
    python chip_smoke.py ;;
  gpu-tests)  # the gpu-marked tests, on a GPU
    FA_TEST_PLATFORM=gpu python -m pytest tests/ -q -m gpu ;;
  bench)   # one JSON line of results on one GPU
    python bench.py ;;
  multichip)  # 8-virtual-device sharding dryrun (CPU)
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('ok')" ;;
  *) echo "usage: tools/ci.sh [smoke|full|chip|gpu-tests|bench|multichip]"; exit 2 ;;
esac
