# femto_tpu build/test entry points.
#
#   make check    — full test suite, one pytest process per test file
#                   (see run_tests.sh for why isolation is required)
#   make native   — build the native C++ IO helper library
#   make bench    — run the single-GPU benchmark (needs a GPU)

.PHONY: check native bench

check:
	./run_tests.sh -j4

native:
	$(MAKE) -C native

bench:
	python bench.py
