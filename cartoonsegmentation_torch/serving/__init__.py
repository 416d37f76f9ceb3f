"""Out-of-process service seams of the port: the stable-diffusion-webui
HTTP client (``sd_webui.py``)."""
