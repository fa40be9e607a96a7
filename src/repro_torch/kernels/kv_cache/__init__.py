"""KV-cache block compression over the mask_pack kernel."""
