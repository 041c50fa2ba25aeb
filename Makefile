# Build system for convolutionalencdec (the reference's C14 analogue,
# but one top-level entry instead of four per-exe Makefiles).

CXX ?= g++
CXXFLAGS ?= -O2 -std=c++17 -fPIC
NATIVE_DIR := convolutionalencdec/native

.PHONY: all native test bench ber clean

all: native

native: $(NATIVE_DIR)/libfec_oracle.so $(NATIVE_DIR)/libturbo_oracle.so

$(NATIVE_DIR)/libfec_oracle.so: $(NATIVE_DIR)/fec_oracle.cpp
	$(CXX) $(CXXFLAGS) -shared $< -o $@

$(NATIVE_DIR)/libturbo_oracle.so: $(NATIVE_DIR)/turbo_oracle.cpp
	$(CXX) $(CXXFLAGS) -shared $< -o $@

test: native
	python -m pytest tests/ -q

bench:
	python bench.py

ber:
	python -c "from convolutionalencdec.harness import run_reference_ber_test as r; import sys; sys.exit(0 if all(p.passed for p in r()) else 1)"

clean:
	rm -f $(NATIVE_DIR)/libfec_oracle.so $(NATIVE_DIR)/libturbo_oracle.so
	find . -name __pycache__ -type d -exec rm -rf {} +
