#!/bin/sh
# Build the native IO runtime -> native/libmvs_io.so (or the path in $1)
set -e
cd "$(dirname "$0")"
OUT="${1:-libmvs_io.so}"
g++ -O3 -march=native -shared -fPIC -pthread -o "$OUT" mvs_io.cpp
echo "built $OUT"
