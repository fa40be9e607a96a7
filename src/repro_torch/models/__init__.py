"""Decoder-LM layers, GQA attention and the LM stack."""
