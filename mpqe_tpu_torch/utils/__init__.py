"""Host-side utilities of the port (counterpart of ``mpqe_tpu/utils``):
``profiling``, the timing harness and rooflines on the card."""
