"""Small host-side helpers shared by the port's config parsers."""
