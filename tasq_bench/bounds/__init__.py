"""The yardstick's arithmetic: the card's data-sheet peaks and the least
time each kernel, and each decide, needs for the work its inputs ask
for."""
