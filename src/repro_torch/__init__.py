"""PyTorch port of the DTWN system (``repro``) for one NVIDIA H100.

The package mirrors ``repro``'s layout (``repro/<pkg>/<mod>.py`` becomes
``repro_torch/<pkg>/<mod>.py``) and keeps its public names. It imports
torch and numpy only. Entry points run on ``cuda`` unless the caller names
another device, and raise when no card is present.
"""
