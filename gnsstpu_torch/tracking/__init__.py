"""Tracking of the port: the exact scan tracker (oracle), the fused K1
tracker, lock detection and the per-family engine adapters. Submodules
are imported where used, so importing one pulls in no other."""
