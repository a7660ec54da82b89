"""Fused VSA unbind -> dense classify head kernel (MIMONet's symbolic tail)."""
