"""The host-side data layer of the port (``tpuhar.data`` counterparts): the manifest
schema and split parsing (``manifest``), the batch loaders (``loader``) and the frame
bank reader (``frames``). numpy on the host; pandas and OpenCV are imported only by the
functions that read a DataFrame or decode a clip."""
