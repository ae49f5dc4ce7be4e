"""The bound arithmetic: the card's peaks and what each layer's work
needs."""
