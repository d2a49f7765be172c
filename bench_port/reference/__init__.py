"""The plain reference the benchmark holds the program to: the numpy
decoder (decoder_np.py, a frozen copy of the repo's NpDecoder, bit-exact
against the C++ reference decoder), its symbol layer (symbols.py), and
NpDecoder's recorded CRCs of the benchmark's streams (crc/). It imports
nothing of the program and nothing of JAX."""
