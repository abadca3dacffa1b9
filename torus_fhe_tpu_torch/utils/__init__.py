"""Utilities around the schemes: key and ciphertext files (``serialize``)."""
