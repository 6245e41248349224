"""Worker-axis exchange of the port: layout, collectives over the stacked
worker dim, and bit accounting (``repro.comm``'s counterpart)."""
from .transport import Transport, build_transport
