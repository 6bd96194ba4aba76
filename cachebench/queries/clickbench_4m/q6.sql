SELECT MIN("EventDate"::INT::DATE), MAX("EventDate"::INT::DATE) FROM hits;

