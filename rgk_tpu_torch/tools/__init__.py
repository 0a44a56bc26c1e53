"""Kernel probes of the port: the reference's probe tools (tools/
prof_smem_probe.py, tools/prof_sync.py) answered for the H100."""
