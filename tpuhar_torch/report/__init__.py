"""Reports of the port: article tables (``tables``) and plots (``plots``); pandas and
matplotlib are imported by the functions that use them."""
