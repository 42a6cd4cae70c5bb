"""Appearance: OSNet ReID embeddings, BN folding and the OSBlock kernel."""
