"""Service seams of the port: the interactive Ken Burns server and its
browser UI (``interface.py``, ``webui.py``) and the
stable-diffusion-webui HTTP client (``sd_webui.py``)."""
