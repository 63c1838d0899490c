"""CRAM 3.0 read and write (reference parity: ``impl/formats/cram/``).

Host code as in the reference — container walk, block CRC, GZIP/BZIP2/
LZMA and order-1 rANS, record assembly, CRAM encode — with every order-0
rANS stream of a split decoded on the device (kernel B3, or B5 under
``DISQ_TPU_TORCH_DEVICE_RANS=legacy``).
"""
