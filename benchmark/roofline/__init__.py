"""The yardstick's count functions: the bytes and operations a problem
needs, and the published peaks of the card that bound them."""
