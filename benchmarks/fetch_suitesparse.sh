#!/bin/bash
# Fetch the reference's SuiteSparse benchmark matrices (Julia/benchmark.jl:21-28).
#
# NOTE: the build/CI environment for this repo has ZERO network egress, so
# this script cannot run there — it is committed for machines that do have
# network access.  In the egress-less environment the benchmark-class
# matrix is assembled instead (rbl/utils/fem.py: a real 3-D
# linear-elasticity stiffness matrix in the same ldoor/hood family), via
# `python examples/benchmark.py --fem3d 42 ...`.
set -euo pipefail
dest=${1:-benchmarks/matrices}
mkdir -p "$dest"
base=https://suitesparse-collection-website.herokuapp.com/MM
for m in GHS_psdef/ldoor DNVS/hood GHS_psdef/audikw_1; do
  name=$(basename "$m")
  echo "fetching $m ..."
  curl -L "$base/$m.tar.gz" | tar -xz -C "$dest"
  mv "$dest/$name/$name.mtx" "$dest/" && rmdir --ignore-fail-on-non-empty "$dest/$name"
done
echo "done: $dest"
