#!/bin/sh
# Build the native codec with ThreadSanitizer or AddressSanitizer and run
# the thread-stress tests against it.  Usage: scripts/sanitize_native.sh
# [tsan|asan].  Restores the normal build afterwards.
set -eu
MODE="${1:-tsan}"
[ "$#" -gt 0 ] && shift
case "$MODE" in
  tsan) FLAG=-fsanitize=thread ;;
  asan) FLAG=-fsanitize=address ;;
  *) echo "usage: $0 [tsan|asan]" >&2; exit 2 ;;
esac
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
# Build the sanitized library at the path the loader expects for the
# current sources (minlz_jax/native/build.py keys it by a source hash).
SO="$(cd "$ROOT" && python -c 'from minlz_jax.native.build import lib_path; print(lib_path())')"
mkdir -p "$(dirname "$SO")"
rm -f "$SO"
g++ -O1 -g -fPIC -shared -fvisibility=hidden $FLAG \
  "$ROOT"/minlz_jax/native/*.cpp -o "$SO"
# TSAN needs to be preloaded into the Python process.
if [ "$MODE" = tsan ]; then
  PRELOAD="$(g++ -print-file-name=libtsan.so)"
else
  PRELOAD="$(g++ -print-file-name=libasan.so)"
fi
LD_PRELOAD="$PRELOAD" JAX_PLATFORMS=cpu \
  python -m pytest "$ROOT/tests/test_native_threads.py" -v "$@" || STATUS=$?
rm -f "$SO"  # force a clean (non-sanitized) rebuild on next import
exit "${STATUS:-0}"
