"""One general generator a kind of traffic, named by a mix's `driver`."""
