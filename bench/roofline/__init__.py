"""The benchmark's own operation and byte counts (:mod:`.flops`) and the
cards' peaks (:mod:`.peaks`)."""
