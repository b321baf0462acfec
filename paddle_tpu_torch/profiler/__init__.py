"""Host-span plumbing (``_hooks``): where the serving loop reports its
segments and requests as timed spans."""
