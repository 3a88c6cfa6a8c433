"""Operations and bytes of the measured work, from shapes alone, and the
table of the card's peaks. A roofline share divides the least time these
allow by the time the trace measured."""
